"""Resource watcher: mtime-polled file-change notifications.

Port of elasticsearch_tpu/watcher.py (reference: org/elasticsearch/watcher/,
ResourceWatcherService.java and FileWatcher.java: ES polls registered
files and directories on an interval and fires listeners on create,
change and delete, for config reloads such as synonym files). Register
paths with listeners; ``check_now()`` runs one poll round, ``start()``
polls on a daemon thread.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

Listener = Callable[[str, str], None]  # (path, event: created|changed|deleted)


class ResourceWatcherService:
    def __init__(self, interval: float = 5.0):
        self.interval = interval
        self._watched: Dict[str, Tuple[Optional[float], List[Listener]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _mtime(path: str) -> Optional[float]:
        try:
            return os.stat(path).st_mtime
        except OSError:
            return None

    def add(self, path: str, listener: Listener) -> None:
        with self._lock:
            mt, listeners = self._watched.get(path, (self._mtime(path), []))
            listeners.append(listener)
            self._watched[path] = (mt, listeners)

    def remove(self, path: str) -> None:
        with self._lock:
            self._watched.pop(path, None)

    def check_now(self) -> int:
        """One poll round; returns how many events fired."""
        fired = 0
        with self._lock:
            items = list(self._watched.items())
        for path, (old_mt, listeners) in items:
            new_mt = self._mtime(path)
            event = None
            if old_mt is None and new_mt is not None:
                event = "created"
            elif old_mt is not None and new_mt is None:
                event = "deleted"
            elif old_mt is not None and new_mt is not None and new_mt != old_mt:
                event = "changed"
            if event:
                with self._lock:
                    # re-read the current listener list under the lock:
                    # writing back the snapshot's list would revert a
                    # concurrent remove()+add() cycle to the stale list
                    # and drop its listeners
                    cur = self._watched.get(path)
                    if cur is not None:
                        self._watched[path] = (new_mt, cur[1])
                for fn in listeners:
                    try:
                        fn(path, event)
                        fired += 1
                    except Exception:
                        pass  # a broken listener must not stop the watcher
        return fired

    def start(self) -> None:
        if self._thread is not None:
            return
        # per-start stop event: an old poller that outlived a timed-out
        # join keeps ITS event (forever set) and exits at its next wait —
        # clearing a shared event could revive it alongside the new poller
        stop = threading.Event()
        self._stop = stop
        self._thread = threading.Thread(target=self._loop, args=(stop,),
                                        name="resource-watcher", daemon=True)
        self._thread.start()

    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            self.check_now()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval + 1.0)
        self._thread = None
