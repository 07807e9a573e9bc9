"""Transport: action dispatch, in-process and over TCP JSON framing.

Port of elasticsearch_tpu/cluster/transport.py (reference:
org/elasticsearch/transport/ — TransportService.java, handlers registered
by action name and sendRequest; netty/NettyTransport.java, the wire).
Between the port's member processes this is both the control plane
(pings, votes, publication, shard commands) and the data plane (routed
writes, the query and fetch phases, recovery streams): no collective
crosses processes.

Wire format: 4-byte big-endian length prefix + UTF-8 JSON
{"action": str, "payload": {...}} → {"ok": bool, "result"|"error": ...}.
One request per connection round; connections are short-lived (control
traffic is low-rate, so simplicity beats pooling here).
"""
from __future__ import annotations

import json
import random
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from elasticsearch_tpu_torch.tracing import adopt_wire_context, wire_context
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.utils.faults import FAULTS
from elasticsearch_tpu_torch.utils.wire import attach_ctx, extract_ctx


#: the bound on a connect, below a round's timeout. A member on loopback
#: or a LAN completes a handshake in milliseconds, and the fault detector
#: already calls a peer dead that takes its 1 s ping to answer; where a
#: host drops (rather than refuses) a connect to a closed port, a request
#: to a member that just died would otherwise wait out its whole timeout,
#: 30 s for a write (ROADMAP C27)
CONNECT_TIMEOUT = 2.0


class TransportError(ElasticsearchTpuException):
    status = 500
    error_type = "transport_error"


class ConnectTransportError(TransportError):
    """The connection could never be established (refused, unreachable,
    connect timeout). The request was NEVER handed to the peer, so a
    retry is safe for ANY action — idempotent or not (reference:
    transport/ConnectTransportError.java; retry-on-connect is the one
    universally safe transport retry). ``timed_out`` distinguishes a
    connect TIMEOUT (budget-sensitive) from an instant refusal."""

    status = 503
    error_type = "connect_transport_error"
    timed_out = False


class ReceiveTimeoutTransportError(TransportError):
    """The request was sent but no response arrived in time. The peer MAY
    have executed it, so only idempotent actions may retry (reference:
    transport/ReceiveTimeoutTransportError.java)."""

    status = 503
    error_type = "receive_timeout_transport_error"


class NodeUnavailableException(TransportError):
    """The per-peer breaker is open: the node failed repeatedly and is
    being skipped for a cooldown window — fail fast instead of burning
    the caller's deadline on a peer that just refused N times."""

    status = 503
    error_type = "node_unavailable_exception"


class RemoteException(TransportError):
    """An ElasticsearchTpuException relayed from a peer: the original
    type name and HTTP status survive the wire, so a 404 document-missing
    raised on a shard's owner surfaces as a 404 on the coordinator —
    never a generic 500 transport_error (reference: netty transport
    serializes the exception class across nodes). Subclasses
    TransportError so `except TransportError` call sites keep catching
    every remote failure."""

    def __init__(self, msg: str, error_type: str, status: int):
        super().__init__(msg)
        self._remote_type = error_type
        self.status = status

    @property
    def error_type(self) -> str:  # the base derives it from the class name
        return self._remote_type


Handler = Callable[[dict], Any]


class BackoffPolicy:
    """Bounded exponential backoff with deterministic jitter.

    Reference: action/bulk/BackoffPolicy.java (exponential, iterator of
    delays). Jitter draws from ``random.Random`` seeded by (seed, salt)
    — fully reproducible in chaos tests, while distinct nodes (seed =
    node-id hash) and distinct (peer, action) salts de-correlate retry
    schedules in production instead of synchronizing the herd.
    """

    def __init__(self, base: float = 0.05, multiplier: float = 2.0,
                 max_delay: float = 1.0, jitter: float = 0.5,
                 seed: int = 0):
        self.base = base
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.jitter = jitter
        self.seed = seed

    def delays(self, retries: int,
               salt: Optional[str] = None) -> Iterator[float]:
        seed = self.seed
        if salt is not None:
            # crc32, not hash(): str hashing is salted per process and
            # would break replay determinism
            seed = zlib.crc32(f"{self.seed}|{salt}".encode())
        rng = random.Random(seed)
        for attempt in range(retries):
            raw = min(self.base * (self.multiplier ** attempt),
                      self.max_delay)
            # jitter shrinks the delay only (never past max_delay, never
            # below (1-jitter)*raw) — full-jitter style, bounded
            yield raw * (1.0 - self.jitter * rng.random())


class PeerBreaker:
    """Per-peer circuit breaker: after ``threshold`` consecutive
    failures a peer is skipped for ``cooldown`` seconds, then one probe
    is let through (half-open) — success closes the breaker, failure
    re-opens it for another window. Keeps a flapping node from stalling
    every scatter on its connect timeout (reference: the
    NodesFaultDetection + retry-skip behavior of the coordinator)."""

    def __init__(self, threshold: int = 3, cooldown: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        # peer key -> [consecutive failures, open_until, probe_granted_at]
        self._peers: Dict[Any, list] = {}

    def allow(self, peer: Any) -> bool:
        with self._lock:
            st = self._peers.get(peer)
            if st is None or st[0] < self.threshold:
                return True
            now = self._clock()
            if now >= st[1]:
                # half-open: one probe per cooldown window. The grant is
                # TIMESTAMPED, not a latch — a probe whose caller died
                # before reporting (deadline abort, crash) expires after
                # another cooldown instead of blacklisting the peer for
                # the life of the process.
                if st[2] is not None and now - st[2] < self.cooldown:
                    return False  # a recent probe is (or was) in flight
                st[2] = now       # this caller is the probe
                return True
            return False

    def record_failure(self, peer: Any) -> None:
        with self._lock:
            st = self._peers.setdefault(peer, [0, 0.0, None])
            st[0] += 1
            st[2] = None
            if st[0] >= self.threshold:
                st[1] = self._clock() + self.cooldown

    def record_success(self, peer: Any) -> None:
        with self._lock:
            self._peers.pop(peer, None)


def _send_frame(sock: socket.socket, obj: dict) -> int:
    """Returns the wire bytes written (frame header + body) so callers
    can feed the tx-bytes counter without re-serializing."""
    raw = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(raw)) + raw)
    return len(raw) + 4


def _recv_frame_sized(sock: socket.socket) -> Tuple[Optional[dict], int]:
    """(frame, wire bytes read) — the sized form the rx-bytes counter
    needs; ``_recv_frame`` keeps the plain signature."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None, 0
    (n,) = struct.unpack(">I", header)
    if n > 64 << 20:
        raise TransportError(f"frame of {n} bytes exceeds the 64MB cap")
    body = _recv_exact(sock, n)
    if body is None:
        return None, 4
    return json.loads(body), n + 4


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    return _recv_frame_sized(sock)[0]


def _count_bytes(metrics, direction: str, nbytes: int) -> None:
    """Feed the rx/tx byte counter on a node's registry; a metrics
    failure (or an unwired service) must never fail the frame."""
    if metrics is None or nbytes <= 0:
        return
    try:
        metrics.counter(
            "estpu_transport_bytes_total",
            "Wire bytes moved by the TCP transport, by direction",
            ("direction",)).labels(direction).inc(nbytes)
    except Exception:  # dropping one metric sample must never fail
        pass           # the frame it measured


def _count_event(metrics, name: str, help_: str, action: str) -> None:
    if metrics is None:
        return
    try:
        metrics.counter(name, help_, ("action",)).labels(action).inc()
    except Exception:  # dropping one metric sample must never fail
        pass           # the send it counted


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TransportService:
    """Action registry + local/remote dispatch."""

    def __init__(self, local_node_id: str = "local"):
        self.local_node_id = local_node_id
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional["TcpTransportServer"] = None
        # optional node tracer (cluster/bootstrap.py wires it): when set,
        # every remote send and every handled frame records a span, and
        # the two link into ONE trace via the frame's ctx header
        self.tracer = None
        # optional node metrics registry (bootstrap wires it beside the
        # tracer): rx/tx bytes, per-action latency, retry/breaker counts
        self.metrics = None
        self.breaker = PeerBreaker()
        # node-id-derived seed: each node jitters its retries differently
        self.backoff = BackoffPolicy(seed=zlib.crc32(local_node_id.encode()))

    def register(self, action: str, handler: Handler) -> None:
        self._handlers[action] = handler

    def handle(self, action: str, payload: dict) -> Any:
        h = self._handlers.get(action)
        if h is None:
            raise TransportError(f"no handler for action [{action}]")
        return h(payload)

    def handle_frame(self, action: str, payload: dict,
                     ctx: Optional[dict] = None) -> Any:
        """``handle`` under an adopted wire context: spans opened by the
        handler join the sender's trace, tasks it registers become
        children of the sender's task (the receiving half of the
        observability header both sides of the TCP framing carry)."""
        with adopt_wire_context(ctx):
            if self.tracer is not None:
                with self.tracer.span("transport.handle", action=action):
                    return self.handle(action, payload)
            return self.handle(action, payload)

    # -- local -----------------------------------------------------------------

    def send_local(self, action: str, payload: dict) -> Any:
        return self.handle(action, payload)

    # -- TCP -------------------------------------------------------------------

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        """Start the TCP endpoint; returns the bound (host, port)."""
        self._server = TcpTransportServer(self, host, port)
        return self._server.address

    def send_remote(self, address: Tuple[str, int], action: str,
                    payload: dict, timeout: float = 5.0) -> Any:
        """One request/response round. Failures are TYPED by phase so
        retry logic can tell them apart: a connect-phase failure
        (ConnectTransportError) never reached the peer and is always
        retry-safe; a failure after the request frame went out
        (ReceiveTimeoutTransportError / TransportError) may have
        executed and only idempotent actions may retry."""
        if self.tracer is not None:
            # the send span becomes the wire parent: the peer's handle
            # span (and any tasks it registers) link under it
            with self.tracer.span("transport.send", action=action,
                                  peer=f"{address[0]}:{address[1]}"):
                return self._send_remote(address, action, payload, timeout)
        return self._send_remote(address, action, payload, timeout)

    def _send_remote(self, address: Tuple[str, int], action: str,
                     payload: dict, timeout: float = 5.0) -> Any:
        t_m = time.perf_counter()
        try:
            return self._send_remote_timed(address, action, payload,
                                           timeout)
        except TransportError:
            _count_event(self.metrics, "estpu_transport_errors_total",
                         "Failed transport rounds, by action", action)
            raise
        finally:
            m = self.metrics
            if m is not None:
                try:
                    m.histogram(
                        "estpu_transport_action_duration_seconds",
                        "Client-side transport round latency, by action",
                        ("action",)).labels(action).observe(
                            time.perf_counter() - t_m)
                except Exception:  # a metrics failure must never mask
                    pass  # the send's outcome

    def _send_remote_timed(self, address: Tuple[str, int], action: str,
                           payload: dict, timeout: float = 5.0) -> Any:
        t0 = time.monotonic()
        try:
            # the injected fault rides the same wrapping as a real
            # connect failure: an OSError here becomes a typed
            # ConnectTransportError either way. discovery.partition is
            # the LINK-level form: ctx carries the local node id beside
            # the target address so a test can drop exactly the
            # minority<->majority links, in both directions
            FAULTS.check("discovery.partition", action=action,
                         address=address, local=self.local_node_id)
            FAULTS.check("transport.send", action=action, address=address)
            sock = socket.create_connection(
                address, timeout=min(timeout, CONNECT_TIMEOUT))
        except socket.timeout as e:
            err = ConnectTransportError(
                f"connect to {address} timed out after "
                f"{min(timeout, CONNECT_TIMEOUT)}s for [{action}]")
            err.timed_out = True
            raise err from e
        except OSError as e:
            raise ConnectTransportError(
                f"connect to {address} failed for [{action}]: {e}") from e
        with sock:
            try:
                # `timeout` bounds the whole round, not each phase: a
                # slow accept must not leave the recv another full budget
                sock.settimeout(max(0.001,
                                    timeout - (time.monotonic() - t0)))
                _count_bytes(self.metrics, "tx", _send_frame(
                    sock, attach_ctx(
                        {"action": action, "payload": payload},
                        wire_context())))
                FAULTS.check("transport.recv", action=action,
                             address=address)
                resp, rx_bytes = _recv_frame_sized(sock)
                _count_bytes(self.metrics, "rx", rx_bytes)
            except socket.timeout as e:
                raise ReceiveTimeoutTransportError(
                    f"no response from {address} within {timeout}s "
                    f"for [{action}]") from e
            except OSError as e:
                raise TransportError(
                    f"mid-request failure talking to {address} "
                    f"for [{action}]: {e}") from e
        if resp is None:
            raise TransportError(f"connection closed by {address}")
        if not resp.get("ok"):
            if resp.get("error_type"):
                raise RemoteException(resp.get("error", "remote failure"),
                                      resp["error_type"],
                                      int(resp.get("status", 500)))
            raise TransportError(resp.get("error", "remote failure"))
        return resp.get("result")

    def send_with_retry(self, address: Tuple[str, int], action: str,
                        payload: dict, *, timeout: float = 5.0,
                        retries: int = 2,
                        deadline: Optional[float] = None,
                        backoff: Optional[BackoffPolicy] = None) -> Any:
        """``send_remote`` for IDEMPOTENT actions: bounded exponential
        backoff on transport-level failures, per-peer breaker, optional
        absolute deadline (``time.monotonic()`` value) that caps every
        attempt's socket timeout. Application-level failures relayed
        from the peer (RemoteException) are never retried — the handler
        ran and answered."""
        policy = backoff or self.backoff
        # per-(peer, action) jitter stream: one shared policy must not
        # hand every peer the identical retry schedule
        delays = policy.delays(retries, salt=f"{address}|{action}")
        last: Optional[TransportError] = None
        for attempt in range(retries + 1):
            budget = timeout
            truncated = False
            if deadline is not None:
                # budget BEFORE breaker.allow: a deadline abort must not
                # consume (and then abandon) the breaker's half-open probe
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ReceiveTimeoutTransportError(
                        f"deadline exhausted before [{action}] to "
                        f"{address} could run") from last
                if remaining < budget:
                    budget, truncated = remaining, True
            if not self.breaker.allow(address):
                _count_event(self.metrics,
                             "estpu_transport_breaker_open_total",
                             "Sends refused by an open per-peer breaker, "
                             "by action", action)
                if last is not None:
                    # the breaker opened DURING this call's retries: the
                    # real typed failure is more useful than the breaker's
                    raise last
                raise NodeUnavailableException(
                    f"peer {address} is cooling down after repeated "
                    f"failures (skipping [{action}])")
            try:
                result = self.send_remote(address, action, payload,
                                          timeout=budget)
            except RemoteException:
                self.breaker.record_success(address)  # the peer answered
                raise
            except TransportError as e:
                budget_induced = truncated and (
                    isinstance(e, ReceiveTimeoutTransportError)
                    or getattr(e, "timed_out", False))
                if not budget_induced:
                    # …but a TIMEOUT under a deadline-TRUNCATED socket
                    # budget says more about this caller's deadline than
                    # about the peer's health — it must not open the
                    # breaker for every other caller (instant refusals
                    # still count regardless of budget)
                    self.breaker.record_failure(address)
                last = e
                if attempt < retries:
                    delay = next(delays)
                    if deadline is not None and \
                            time.monotonic() + delay >= deadline:
                        break  # sleeping would blow the deadline
                    _count_event(self.metrics,
                                 "estpu_transport_retries_total",
                                 "Transport retry attempts, by action",
                                 action)
                    time.sleep(delay)
                continue
            self.breaker.record_success(address)
            return result
        assert last is not None
        raise last

    def ping(self, address: Tuple[str, int], timeout: float = 1.0) -> bool:
        try:
            return self.send_remote(address, "internal:ping", {}, timeout) == "pong"
        except Exception:
            return False

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    # socketserver's default backlog of 5 drops the handshakes of a burst
    # of concurrent rounds (a bulk's routed writes and replica copies)
    # and leaves them to the client's SYN retries, past CONNECT_TIMEOUT
    request_queue_size = 128


class TcpTransportServer:
    def __init__(self, service: TransportService, host: str, port: int):
        service.register("internal:ping", lambda payload: "pong")

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: N802 (socketserver API)
                try:
                    req, rx_bytes = _recv_frame_sized(self.request)
                    _count_bytes(service.metrics, "rx", rx_bytes)
                    if req is None:
                        return
                    try:
                        result = service.handle_frame(
                            req.get("action", ""), req.get("payload", {}),
                            ctx=extract_ctx(req))
                        _count_bytes(service.metrics, "tx", _send_frame(
                            self.request, {"ok": True, "result": result}))
                    except ElasticsearchTpuException as e:
                        # typed relay: the caller re-raises with the
                        # original error_type + HTTP status
                        _count_bytes(service.metrics, "tx", _send_frame(
                            self.request, {
                                "ok": False, "error": str(e),
                                "error_type": getattr(e, "error_type",
                                                      "internal_error"),
                                "status": getattr(e, "status", 500)}))
                    except Exception as e:  # handler errors go back as frames
                        _count_bytes(service.metrics, "tx", _send_frame(
                            self.request, {"ok": False, "error": str(e)}))
                except Exception:
                    pass  # broken pipe / malformed frame: drop the connection

        self._srv = _Server((host, port), _Handler, bind_and_activate=True)
        self.address = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="tpu-transport", daemon=True)
        self._thread.start()

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()
