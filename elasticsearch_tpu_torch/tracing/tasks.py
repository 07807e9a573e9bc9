"""Task management: the node's registry with cooperative cancellation.

Port of elasticsearch_tpu/tracing/tasks.py (reference: ES's
TaskManager.java, registering and unregistering around every action;
Task.java / CancellableTask, whose ``isCancelled`` flag long actions
poll; and action/admin/cluster/node/tasks/, the list and cancel actions
behind ``GET /_tasks`` and ``POST /_tasks/{id}/_cancel``).

Tasks are identified as ``node_id:seq`` as in ES. Cancellation is
cooperative: long loops (by-query scans, scroll paging, force-merge,
recovery replay) call ``check_cancelled()`` between units of work; a
whole-segment device program is not interruptible. The coalescer's
parked requests register here too, and their cancel wakes the waiter.
Parent links cross the transport between processes in the wire header
the tracer rides (``adopt_parent``/``wire_parent``), so cancelling a
coordinator's task reaches its remote children.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  TaskCancelledException)

__all__ = ["Task", "TaskRegistry", "TaskCancelledException",
           "ResourceNotFoundException", "human_time", "current_task",
           "set_current", "reset_current", "check_cancelled",
           "task_header", "adopt_parent", "wire_parent"]


class ResourceNotFoundException(ElasticsearchTpuException):
    status = 404


ParentId = Tuple[str, int]  # (node_id, task seq)


def human_time(nanos: int) -> str:
    """Human-scaled duration (reference: TimeValue.toString — the form
    every `_cat` duration column prints): ``850micros``, ``770ms``,
    ``12.3s``, ``4.5m``, ``1.2h``. The point of printing it beside the
    nanos: an operator scanning `_cat/tasks` tells a fresh task from
    one wedged for minutes at a glance."""
    n = max(0, int(nanos))
    if n < 1_000_000:
        return f"{n // 1000}micros"
    ms = n / 1e6
    if ms < 1000:
        return f"{ms:.1f}ms" if ms < 10 else f"{int(ms)}ms"
    s = ms / 1000.0
    if s < 60:
        return f"{s:.1f}s"
    m = s / 60.0
    if m < 60:
        return f"{m:.1f}m"
    return f"{m / 60.0:.1f}h"


class Task:
    def __init__(self, task_id: int, node: str, action: str,
                 description: str = "", parent: Optional[ParentId] = None,
                 cancellable: bool = True, status: str = "running"):
        self.id = task_id
        self.node = node
        self.action = action
        self.description = description
        self.parent = parent
        self.cancellable = cancellable
        self.status = status  # "pending" | "running"
        self.start_time_ms = int(time.time() * 1000)  # display only
        self._start = time.monotonic()
        self._cancelled = threading.Event()
        self.cancel_reason: Optional[str] = None
        # optional eager-cleanup hook, fired ONCE on the cancelling
        # thread: tasks guarding a resource no cooperative checkpoint
        # may ever revisit (an abandoned scroll context) free it here
        # instead of waiting for a client that might never return
        self.on_cancel: Optional[Callable[["Task"], None]] = None

    @property
    def tagged_id(self) -> str:
        return f"{self.node}:{self.id}"

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, reason: str = "by user request") -> bool:
        if not self.cancellable:
            return False
        if not self._cancelled.is_set():
            self.cancel_reason = reason
            self._cancelled.set()
            cb = self.on_cancel
            if cb is not None:
                try:
                    cb(self)
                except Exception:
                    pass  # cleanup is best-effort; the flag is what counts
        return True

    def check_cancelled(self) -> None:
        if self._cancelled.is_set():
            raise TaskCancelledException(
                f"task [{self.tagged_id}] ({self.action}) was cancelled "
                f"[{self.cancel_reason or 'by user request'}]")

    def start(self) -> None:
        """pending → running (queued work that just began executing)."""
        self.status = "running"
        self._start = time.monotonic()

    def running_time_nanos(self) -> int:
        return int((time.monotonic() - self._start) * 1e9)

    def to_json(self) -> dict:
        nanos = self.running_time_nanos()
        out = {
            "node": self.node,
            "id": self.id,
            "type": "transport",
            "action": self.action,
            "description": self.description,
            "status": self.status,
            "start_time_in_millis": self.start_time_ms,
            "running_time_in_nanos": nanos,
            # the human form beside the nanos (computed from the task's
            # monotonic start): GET /_tasks consumers get both without
            # re-deriving the scale
            "running_time": human_time(nanos),
            "cancellable": self.cancellable,
            "cancelled": self.cancelled,
        }
        if self.parent is not None:
            out["parent_task_id"] = f"{self.parent[0]}:{self.parent[1]}"
        return out


# the task the CURRENT flow of execution runs under (set by
# TaskRegistry.task); checkpoints read it without plumbing a handle
# through every call signature
_CURRENT_TASK: contextvars.ContextVar[Optional[Task]] = \
    contextvars.ContextVar("estpu-torch-current-task", default=None)
# the parent task adopted from a transport wire header (a remote parent:
# there is no local Task object for it)
_WIRE_PARENT: contextvars.ContextVar[Optional[ParentId]] = \
    contextvars.ContextVar("estpu-torch-wire-parent-task", default=None)


def current_task() -> Optional[Task]:
    return _CURRENT_TASK.get()


def set_current(task: Optional[Task]):
    """Make ``task`` the current task of this flow; returns the reset
    token (for callers whose enter/exit can't be a with-block, e.g. the
    recovery runner driving several sequential task lifetimes)."""
    return _CURRENT_TASK.set(task)


def reset_current(token) -> None:
    _CURRENT_TASK.reset(token)


def check_cancelled() -> None:
    """Cooperative checkpoint: no-op when the current flow runs under no
    task; raises TaskCancelledException when its task was cancelled."""
    task = _CURRENT_TASK.get()
    if task is not None:
        task.check_cancelled()


def task_header() -> Optional[dict]:
    """The current task as a header dict (``{"node", "id"}``) for parent
    propagation; None outside a task."""
    task = _CURRENT_TASK.get()
    if task is None:
        return None
    return {"node": task.node, "id": task.id}


@contextmanager
def adopt_parent(header: Optional[dict]) -> Iterator[None]:
    """Adopt a remote parent task from a wire header: tasks registered
    inside become its children (and die with it on a cascade cancel). A
    non-int id is ignored, not raised: a junk observability header must
    never fail a valid frame."""
    tid = (header or {}).get("id")
    if not isinstance(tid, int) or isinstance(tid, bool):
        yield
        return
    token = _WIRE_PARENT.set((str(header.get("node") or ""), tid))
    try:
        yield
    finally:
        _WIRE_PARENT.reset(token)


def wire_parent() -> Optional[ParentId]:
    return _WIRE_PARENT.get()


class TaskRegistry:
    """All in-flight tasks of one node (reference: TaskManager)."""

    #: bounded ban memory: cancelled parent ids a LATE-registering child
    #: must still die under (see register); FIFO-evicted past this many
    _BAN_CAP = 1024

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._tasks: Dict[int, Task] = {}
        # parent id -> cancel reason (reference: TransportCancelTasksAction
        # sets a BAN on the parent so children registering after the
        # cancel fanout processed still cancel at registration — without
        # it, a cancel racing the coordinator's in-flight child dispatch
        # reports "canceled" while the remote destructive pass runs to
        # completion)
        from collections import OrderedDict

        self._banned: "OrderedDict[ParentId, str]" = OrderedDict()
        self.completed_total = 0
        self.cancelled_total = 0

    # -- lifecycle -----------------------------------------------------------

    def register(self, action: str, description: str = "",
                 parent: Optional[ParentId] = None,
                 cancellable: bool = True,
                 status: str = "running",
                 on_cancel: Optional[Callable[[Task], None]] = None) -> Task:
        """Register a task. ``parent`` defaults to the current local task
        or, failing that, the remote parent adopted from the transport
        wire header.
        ``on_cancel`` must be given HERE (not assigned afterwards) when
        the task guards a resource: the task is cancellable the instant
        it publishes — a cancel (or the born-cancelled ban path below)
        landing before a late assignment would skip the cleanup
        forever."""
        if parent is None:
            cur = _CURRENT_TASK.get()
            if cur is not None:
                parent = (cur.node, cur.id)
            else:
                parent = _WIRE_PARENT.get()
        task = Task(next(self._seq), self.node_id, action,
                    description=description, parent=parent,
                    cancellable=cancellable, status=status)
        task.on_cancel = on_cancel
        with self._lock:
            self._tasks[task.id] = task
            ban_reason = (self._banned.get(parent)
                          if parent is not None else None)
        if ban_reason is not None:
            # born cancelled: the parent was cancelled before this child
            # registered — its first checkpoint raises immediately
            task.cancel(ban_reason)
        return task

    def unregister(self, task: Task) -> None:
        with self._lock:
            gone = self._tasks.pop(task.id, None)
            if gone is not None:
                self.completed_total += 1
                if gone.cancelled:
                    self.cancelled_total += 1

    @contextmanager
    def task(self, action: str, description: str = "",
             parent: Optional[ParentId] = None,
             cancellable: bool = True) -> Iterator[Task]:
        """Run a block as a registered task: the task becomes the current
        task of this flow (checkpoints see it, children parent to it)."""
        t = self.register(action, description=description, parent=parent,
                          cancellable=cancellable)
        token = _CURRENT_TASK.set(t)
        try:
            yield t
        finally:
            _CURRENT_TASK.reset(token)
            self.unregister(t)

    # -- views ---------------------------------------------------------------

    def get(self, task_id: int) -> Optional[Task]:
        with self._lock:
            return self._tasks.get(task_id)

    def list_tasks(self, actions: Optional[str] = None) -> List[Task]:
        """Snapshot, optionally filtered by a comma-joined action pattern
        list (``*`` wildcards, reference: ListTasksRequest.actions)."""
        import fnmatch

        with self._lock:
            tasks = sorted(self._tasks.values(), key=lambda t: t.id)
        if not actions:
            return tasks
        pats = [a.strip() for a in str(actions).split(",") if a.strip()]
        return [t for t in tasks
                if any(fnmatch.fnmatch(t.action, p) for p in pats)]

    def pending_tasks(self) -> List[dict]:
        """Registered-but-not-yet-running tasks in /_cluster/pending_tasks
        shape (insertOrder = task seq, timeInQueue from the monotonic
        clock)."""
        out = []
        for t in self.list_tasks():
            if t.status != "pending":
                continue
            ms = t.running_time_nanos() // 1_000_000
            out.append({"insert_order": t.id, "priority": "NORMAL",
                        "source": t.action or t.description,
                        "time_in_queue_millis": ms,
                        "time_in_queue": f"{ms}ms"})
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"current": len(self._tasks),
                    "completed_total": self.completed_total,
                    "cancelled_total": self.cancelled_total}

    # -- cancellation --------------------------------------------------------

    def _ban(self, parent: ParentId, reason: str) -> None:
        with self._lock:
            self._banned[parent] = reason
            self._banned.move_to_end(parent)
            while len(self._banned) > self._BAN_CAP:
                self._banned.popitem(last=False)

    def cancel(self, task_id: int,
               reason: str = "by user request") -> List[Task]:
        """Cancel a task and (recursively) its local descendants. Remote
        children are the transport layer's job
        (cluster/search_action.py::cancel_task_children fans the parent
        id to every member). Returns the tasks actually cancelled."""
        task = self.get(task_id)
        if task is None:
            raise ResourceNotFoundException(
                f"task [{self.node_id}:{task_id}] isn't running and "
                "hasn't stored its results")
        out = []
        if task.cancel(reason):
            out.append(task)
        self._ban((self.node_id, task_id), reason)
        out.extend(self.cancel_by_parent(self.node_id, task_id, reason))
        return out

    def cancel_by_parent(self, parent_node: str, parent_id: int,
                         reason: str = "by user request") -> List[Task]:
        """Cancel every local task descending from (parent_node,
        parent_id) — the receiving half of cross-node cascade cancel.
        The parent id is also BANNED: a child that registers after this
        fanout (the coordinator's dispatch was in flight) is born
        cancelled instead of escaping the cascade."""
        self._ban((parent_node, parent_id), reason)
        with self._lock:
            snapshot = list(self._tasks.values())
        out: List[Task] = []
        want = {(parent_node, parent_id)}
        # fixed point over the local parent links: children of cancelled
        # children cancel too
        changed = True
        while changed:
            changed = False
            for t in snapshot:
                if t.parent in want and (t.node, t.id) not in want:
                    if t.cancel(reason):
                        out.append(t)
                    want.add((t.node, t.id))
                    self._ban((t.node, t.id), reason)
                    changed = True
        return out
