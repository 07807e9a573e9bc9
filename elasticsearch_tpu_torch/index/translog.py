"""Transaction log.

Reference: org/elasticsearch/index/translog/ — Translog.java (fs),
TranslogWriter-era logic: an append-only durability log, fsync policy,
generation rollover on flush ("commit"), and replay on recovery.

On-disk format (v2): binary frames
    [0xE5][u8 version][u32be len][u32be crc32(payload)][payload JSON bytes]
with the CRC from ``zlib.crc32`` — the same checksum the JAX package's
native codec computes, so a translog written by either package replays
in the other, and the same role as the reference's
BufferedChecksumStreamOutput (java.util.zip.CRC32): a torn or bit-rotted
tail is DETECTED, not silently half-parsed. Replay verifies every frame
and stops at the first bad one. Legacy v1 JSON-lines generations are still
readable (format auto-detected per file).

Lock order: ``Translog._lock`` sits BELOW ``Engine._lock`` (the engine
appends under its own lock); never call back into the engine from under
it.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Iterator, Optional

from elasticsearch_tpu_torch.monitor.metrics import SHARED
from elasticsearch_tpu_torch.utils.faults import FAULTS

_MAGIC = 0xE5
_VERSION = 2
_HEADER = struct.Struct(">BBII")  # magic, version, len, crc


class TranslogClosedException(OSError):
    """Append/sync against a translog whose channel was closed by a
    tragic IO event (or an explicit close). An OSError subclass so the
    engine's tragic-event handler treats it like any other IO failure."""


def fsync_dir(path: str) -> None:
    """Make the entries of directory ``path`` (a file created, renamed
    or removed in it) durable, as an fsync makes a file's bytes."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Translog:
    def __init__(self, path: Optional[str], durability: str = "request", sync_interval: float = 5.0):
        """path=None → in-memory only (durability off, e.g. ephemeral tests).

        durability: "request" fsyncs every append (ES index.translog.durability=
        request); "async" relies on OS flush + periodic sync.
        """
        self.path = path
        self.durability = durability
        self._lock = threading.Lock()
        self._ops_since_sync = 0
        self.generation = 1
        self._fh = None
        self._mem: list = []
        # stats() counters — all mutated under _lock
        self._ops_appended = 0
        self._bytes_written = 0
        self._sync_count = 0
        self._last_sync: Optional[float] = None
        self._corrupt_tail_events = 0
        self._corrupt_tail_bytes = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # find latest generation
            base = os.path.basename(path)
            d = os.path.dirname(path) or "."
            gens = []
            for f in os.listdir(d):
                if f.startswith(base + ".") and f.rpartition(".")[2].isdigit():
                    gens.append(int(f.rpartition(".")[2]))
            self.generation = max(gens) if gens else 1
            # never append v2 frames to a legacy v1 (JSON-lines) generation:
            # the per-file format sniff is first-byte based, so mixing would
            # make replay silently drop the v2 tail. Roll to a fresh
            # generation instead; the old one stays readable for replay.
            gp = self._gen_path(self.generation)
            if os.path.exists(gp) and os.path.getsize(gp) > 0:
                with open(gp, "rb") as f:
                    if f.read(1)[0] != _MAGIC:
                        self.generation += 1
            self._fh = open(self._gen_path(self.generation), "ab")
            fsync_dir(d)  # the generation's entry outlives an OS crash
            # size reflects the CURRENT generation on disk, so a restart
            # with a large un-committed translog reports its real flush
            # pressure (reference: TranslogStats sizeInBytes)
            self._bytes_written = self._fh.tell()

    def _gen_path(self, gen: int) -> str:
        return f"{self.path}.{gen}"

    @property
    def size_in_ops(self) -> int:
        if self.path is None:
            return len(self._mem)
        with self._lock:
            return self._count_ops()

    def _count_ops(self) -> int:
        return sum(1 for _ in self._iter_file(self._gen_path(self.generation)))

    def append(self, op: dict):
        """Durably record one op. An IO/fsync failure is TRAGIC: the
        channel is closed before the error propagates, so no later append
        can extend a generation whose tail may hold a torn frame (the
        CRC framing makes replay stop cleanly at that tail). Reference:
        TranslogWriter.closeWithTragicEvent — a translog that failed a
        write must never accept another op."""
        payload = json.dumps(op, separators=(",", ":")).encode()
        with self._lock:
            if self._fh is None:
                if self.path is None:
                    self._mem.append(op)
                    return
                raise TranslogClosedException(
                    f"translog [{self.path}] is closed")
            start = self._fh.tell()
            try:
                FAULTS.check("translog.append", path=self.path)
                self._fh.write(_HEADER.pack(_MAGIC, _VERSION, len(payload),
                                            zlib.crc32(payload)))
                self._fh.write(payload)
                self._ops_since_sync += 1
                if self.durability == "request":
                    self._sync_locked()
                # bumped only once durability is settled: a tragic append
                # must not count as appended
                self._ops_appended += 1
                self._bytes_written += _HEADER.size + len(payload)
            except OSError:
                # drop the unacknowledged frame where possible so replay
                # state is exactly the acknowledged ops (best-effort: if
                # the disk is the problem, the CRC framing still stops
                # replay at the torn frame)
                self._close_tragic(truncate_to=start)
                raise

    def sync(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._sync_locked()
                except OSError:
                    self._close_tragic()
                    raise

    def _sync_locked(self):
        t0 = time.perf_counter()
        self._fh.flush()
        FAULTS.check("translog.fsync", path=self.path)
        os.fsync(self._fh.fileno())
        self._ops_since_sync = 0
        self._sync_count += 1
        self._last_sync = time.time()
        # the process-shared registry (a translog knows no node): fsync
        # latency is what every doc pays under durability "request"
        try:
            SHARED.histogram(
                "estpu_translog_fsync_duration_seconds",
                "Translog flush+fsync latency").observe(
                    time.perf_counter() - t0)
            SHARED.counter("estpu_translog_fsyncs_total",
                           "Translog fsync operations").inc()
        except Exception:  # a metrics failure must never fail the sync
            pass

    def _close_tragic(self, truncate_to: Optional[int] = None):
        """Close the channel after a failed write/fsync — best-effort,
        the original IO error is what propagates to the engine.
        ``truncate_to`` drops a frame whose durability was never
        confirmed, so a replay after the tragic event yields exactly the
        acknowledged ops."""
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        if truncate_to is not None:
            try:
                os.truncate(self._gen_path(self.generation), truncate_to)
            except OSError:
                pass

    def stats(self) -> dict:
        """Counters for the monitor endpoint (reference: TranslogStats —
        numberOfOperations/translogSizeInBytes, plus our sync/corruption
        accounting)."""
        with self._lock:
            return {
                "operations": (len(self._mem) if self.path is None
                               else self._count_ops()),
                "ops_appended": self._ops_appended,
                "generation": self.generation,
                "size_in_bytes": self._bytes_written,
                "sync_count": self._sync_count,
                "last_sync_millis": (int(self._last_sync * 1000)
                                     if self._last_sync else 0),
                "corrupt_tail_events": self._corrupt_tail_events,
                "corrupt_tail_bytes_dropped": self._corrupt_tail_bytes,
                "closed": self.path is not None and self._fh is None,
            }

    def replay(self, from_generation: int = 1) -> Iterator[dict]:
        """Yield ops from all generations >= from_generation (recovery).

        A corrupt tail is DETECTED, reported (this translog's
        ``corrupt_tail_events`` counter and the process-wide
        ``monitor.stats.TRANSLOG_RECOVERY``), and replay stops at it — acknowledged ops before the
        tear all replay; nothing after it is half-parsed."""
        if self.path is None:
            yield from list(self._mem)
            return
        self.sync()

        def on_corrupt(path: str, bytes_dropped: int, reason: str) -> None:
            from elasticsearch_tpu_torch.monitor.stats import \
                record_corrupt_tail

            with self._lock:
                self._corrupt_tail_events += 1
                self._corrupt_tail_bytes += int(bytes_dropped)
            record_corrupt_tail(path, bytes_dropped, reason)

        for gen in range(from_generation, self.generation + 1):
            yield from self._iter_file(self._gen_path(gen), on_corrupt)

    def ops_above(self, seq_no: int) -> Iterator[dict]:
        """Yield retained ops whose sequence number exceeds ``seq_no`` —
        the raw material of checkpoint-based peer recovery (reference:
        Translog.newSnapshot(fromSeqNo) in the seq-no era). Frames
        without a seq_no (legacy v1/v2 pre-seqno ops) are skipped: the
        caller detects the resulting coverage gap and falls back to a
        full copy. ``commit()`` dropping old generations is what bounds
        this — ops flushed away are gone, by design."""
        for op in self.replay():
            s = op.get("seq_no")
            if s is not None and s > seq_no:
                yield op

    @staticmethod
    def _iter_file(p: str,
                   on_corrupt: Optional[Callable[[str, int, str], None]]
                   = None) -> Iterator[dict]:
        """Parse one generation file; CRC-verified frames (v2) or legacy
        JSON lines (v1). Stops cleanly at the first torn/corrupt record;
        ``on_corrupt(path, bytes_dropped, reason)`` fires when the stop
        was corruption rather than clean EOF."""
        if not os.path.exists(p):
            return
        size = os.path.getsize(p)

        def corrupt(pos: int, reason: str) -> None:
            if on_corrupt is not None:
                on_corrupt(p, size - pos, reason)

        with open(p, "rb") as f:
            first = f.read(1)
            f.seek(0)
            if first and first[0] != _MAGIC:  # legacy v1 JSON lines
                pos = 0
                for line in f:
                    stripped = line.strip()
                    if stripped:
                        try:
                            op = json.loads(stripped)
                        except json.JSONDecodeError:
                            # torn tail write: stop at corruption
                            corrupt(pos, "unparseable v1 line")
                            return
                        yield op
                    pos += len(line)
                return
            while True:
                frame_start = f.tell()
                header = f.read(_HEADER.size)
                if not header:
                    return  # clean EOF
                if len(header) < _HEADER.size:
                    corrupt(frame_start, "torn frame header")
                    return
                magic, version, n, crc = _HEADER.unpack(header)
                if magic != _MAGIC or version != _VERSION:
                    corrupt(frame_start, "bad frame magic/version")
                    return
                payload = f.read(n)
                if len(payload) < n:
                    corrupt(frame_start, "torn frame payload")
                    return
                if zlib.crc32(payload) != crc:
                    corrupt(frame_start, "frame CRC mismatch")
                    return
                try:
                    op = json.loads(payload)
                except json.JSONDecodeError:
                    corrupt(frame_start, "frame JSON undecodable")
                    return
                yield op

    def commit(self):
        """Roll to a new generation and drop old ones (called on flush:
        flushed segments now own the data, like Translog.commit)."""
        with self._lock:
            if self._fh is None:
                if self.path is not None:
                    raise TranslogClosedException(
                        f"translog [{self.path}] is closed")
                self._mem.clear()
                return
            try:
                self._sync_locked()
            except OSError:
                self._close_tragic()
                raise
            self._fh.close()
            old_gen = self.generation
            self.generation += 1
            self._fh = open(self._gen_path(self.generation), "ab")
            fsync_dir(os.path.dirname(self.path) or ".")
            self._bytes_written = 0  # fresh generation
            for gen in range(1, old_gen + 1):
                p = self._gen_path(gen)
                if os.path.exists(p):
                    os.remove(p)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
