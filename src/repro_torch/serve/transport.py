"""Fleet transport for registry replication.

`repro_torch.serve.replication.ReplicatedRegistry` speaks request/response
messages (plain dicts) to its peers through a `Transport`:

  * `LocalBus` — an in-process fake: every host attaches to one bus and
    `send` invokes the destination handler synchronously in the caller's
    thread.  Deterministic by construction (no sockets, no sleeps), with
    fault injection (`partition`/`heal` drop traffic to a host, an
    `intercept` hook can observe or drop individual messages) — the
    transport every replication test runs on.
  * `TCPTransport` — a real socket transport for multi-process fleets:
    each host runs a tiny length-prefixed-pickle server thread; `send`
    opens a connection, writes one request, reads one reply.  Exercised
    by the subprocess fleet test.

Both satisfy the `Transport` protocol: `host_id`, `peers()`, `send()`,
`set_handler()`, `close()`.  A failed delivery (unknown or partitioned
host, dead socket, timeout) raises `TransportError` — the replication
layer treats that as "no ack" and lets anti-entropy repair the host
later, so the transport never needs retries of its own.

Whatever crosses a transport is a host copy: CPU tensors, numpy arrays and
plain Python.  A CUDA tensor pickled onto the wire could not be unpickled by
a peer without a card, and even on `LocalBus` it would hand one host's
device memory to another, so `send` raises `ValueError` for a message that
holds one (`check_host`).

Security note: `TCPTransport` trusts its peers (pickle over localhost) —
it is a test/bench transport for fleets you spawn yourself, not a
hardened RPC layer.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.dr.model import ModelState

Message = Dict[str, Any]
Handler = Callable[[Message], Message]


class TransportError(RuntimeError):
    """Delivery failed (partition, unknown host, dead socket) — no ack."""


def _device_leaf(obj: Any, path: str) -> Optional[str]:
    """The path of the first tensor in `obj` that does not lie on the host."""
    if isinstance(obj, torch.Tensor):
        return None if obj.device.type == "cpu" else f"{path} ({obj.device})"
    if isinstance(obj, ModelState):
        return _device_leaf(obj.stages, path + ".stages") or \
            _device_leaf(obj.steps, path + ".steps")
    if isinstance(obj, dict):
        for k, v in obj.items():
            hit = _device_leaf(v, f"{path}[{k!r}]")
            if hit is not None:
                return hit
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            hit = _device_leaf(v, f"{path}[{i}]")
            if hit is not None:
                return hit
    return None


def check_host(msg: Message) -> None:
    """Raise `ValueError` if `msg` holds a tensor that is not on the host."""
    hit = _device_leaf(msg, "msg")
    if hit is not None:
        raise ValueError(f"a transport carries host copies only; {hit} lies on a device "
                         f"(send durability.host_state(...) instead)")


@runtime_checkable
class Transport(Protocol):
    """What the replication layer needs from a fleet transport."""

    host_id: str

    def peers(self) -> Tuple[str, ...]:
        """Other hosts currently reachable-in-principle (self excluded)."""
        ...

    def send(self, dst: str, msg: Message, *,
             timeout_s: Optional[float] = None) -> Message:
        """Deliver `msg` to `dst`, return its reply; `TransportError` on
        failure.  Blocking, at-most-once.  `timeout_s` caps THIS call
        (None: the transport's default) — election traffic passes a cap
        well below the heartbeat interval so one hung peer can't stall a
        beat round into a spurious failover."""
        ...

    def set_handler(self, handler: Handler) -> None:
        """Install the callable that answers incoming messages."""
        ...

    def close(self) -> None:
        ...


# ---------------------------------------------------------------------------
# in-process bus (deterministic tests)
# ---------------------------------------------------------------------------

class LocalBus:
    """In-process fleet fabric: attach hosts, deliver synchronously.

    `attach(host_id)` returns the host's `Transport` endpoint.  Delivery
    runs the destination handler in the *caller's* thread, so a whole
    replication round trip (op → follower pull → catch-up → ack) is one
    deterministic call stack.  Fault injection:

      * `partition(*hosts)` / `heal(*hosts)` — traffic to or from a
        partitioned host raises `TransportError`;
      * `intercept` — optional `fn(src, dst, msg) -> bool`; return False
        to drop that one message (and raise at the sender).  Also the
        observation point for tests counting payload traffic.
    """

    def __init__(self):
        self._hosts: Dict[str, "_LocalEndpoint"] = {}  # guarded-by: _lock
        self._partitioned: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.intercept: Optional[Callable[[str, str, Message], bool]] = None
        self.sent = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def attach(self, host_id: str) -> "_LocalEndpoint":
        with self._lock:
            if host_id in self._hosts:
                raise ValueError(f"host {host_id!r} already attached")
            ep = _LocalEndpoint(self, host_id)
            self._hosts[host_id] = ep
            return ep

    def detach(self, host_id: str) -> None:
        with self._lock:
            self._hosts.pop(host_id, None)
            self._partitioned.discard(host_id)

    def hosts(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._hosts)

    # ---- fault injection ---------------------------------------------------
    def partition(self, *host_ids: str) -> None:
        with self._lock:
            self._partitioned.update(host_ids)

    def heal(self, *host_ids: str) -> None:
        with self._lock:
            if host_ids:
                self._partitioned.difference_update(host_ids)
            else:
                self._partitioned.clear()

    def partitioned(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._partitioned)

    # ---- delivery ----------------------------------------------------------
    def _send(self, src: str, dst: str, msg: Message) -> Message:
        with self._lock:
            ep = self._hosts.get(dst)
            cut = src in self._partitioned or dst in self._partitioned
            self.sent += 1
        if ep is None or cut:
            with self._lock:
                self.dropped += 1
            raise TransportError(f"{src} -> {dst}: unreachable")
        hook = self.intercept
        if hook is not None and hook(src, dst, msg) is False:
            with self._lock:
                self.dropped += 1
            raise TransportError(f"{src} -> {dst}: dropped by intercept")
        handler = ep._handler
        if handler is None:
            raise TransportError(f"{src} -> {dst}: no handler installed")
        reply = handler(msg)
        check_host(reply)
        return reply


class _LocalEndpoint:
    """One host's view of a `LocalBus` (satisfies `Transport`)."""

    def __init__(self, bus: LocalBus, host_id: str):
        self.bus = bus
        self.host_id = host_id
        self._handler: Optional[Handler] = None

    def peers(self) -> Tuple[str, ...]:
        return tuple(h for h in self.bus.hosts() if h != self.host_id)

    def send(self, dst: str, msg: Message, *,
             timeout_s: Optional[float] = None) -> Message:
        # synchronous in-process delivery: nothing to time out
        check_host(msg)
        return self.bus._send(self.host_id, dst, msg)

    def set_handler(self, handler: Handler) -> None:
        self._handler = handler

    def close(self) -> None:
        self.bus.detach(self.host_id)


# ---------------------------------------------------------------------------
# TCP transport (multi-process fleets)
# ---------------------------------------------------------------------------

_LEN = struct.Struct(">Q")


def _send_frame(sock: socket.socket, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


class TCPTransport:
    """Socket transport: one length-prefixed pickle request per connection.

    Each host binds a listener (`port=0` picks a free port — read
    `.address` after construction) and serves requests on a daemon
    thread.  Peers are added explicitly (`add_peer`) or learned when the
    replication layer handles a `join`.  Every `send` is one fresh
    connection: connect, write request, read reply, close — slow but
    simple, and state-free across fleet restarts.
    """

    def __init__(self, host_id: str, *, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 10.0):
        self.host_id = host_id
        self.timeout_s = timeout_s
        self._peers: Dict[str, Tuple[str, int]] = {}  # guarded-by: _lock
        self._handler: Optional[Handler] = None
        self._lock = threading.Lock()
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.address: Tuple[str, int] = self._srv.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"tcp-transport-{host_id}")
        self._thread.start()

    # ---- peer book ---------------------------------------------------------
    def add_peer(self, host_id: str, address: Tuple[str, int]) -> None:
        with self._lock:
            self._peers[host_id] = tuple(address)

    def peers(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._peers)

    def set_handler(self, handler: Handler) -> None:
        self._handler = handler

    # ---- client side -------------------------------------------------------
    def send(self, dst: str, msg: Message, *,
             timeout_s: Optional[float] = None) -> Message:
        check_host(msg)
        with self._lock:
            addr = self._peers.get(dst)
        if addr is None:
            raise TransportError(f"{self.host_id} -> {dst}: unknown peer")
        budget = self.timeout_s if timeout_s is None else timeout_s
        try:
            with socket.create_connection(addr, timeout=budget) as s:
                s.settimeout(budget)
                _send_frame(s, msg)
                reply = _recv_frame(s)
        except TransportError:
            raise
        except Exception as e:      # noqa: BLE001 — ANY dead-peer failure is
            # a nack: connection refused, reset, timeout, a truncated frame,
            # or unpickling a reply (which can raise arbitrary exceptions,
            # not just PickleError).  The replication layer counts a
            # TransportError as "unreachable toward quorum"; anything else
            # leaking out of send() would abort a whole broadcast instead.
            raise TransportError(f"{self.host_id} -> {dst}: {e!r}") from e
        if isinstance(reply, dict) and "_transport_error" in reply:
            raise TransportError(reply["_transport_error"])
        return reply

    # ---- server side -------------------------------------------------------
    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return                      # listener closed
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(self.timeout_s)
            try:
                msg = _recv_frame(conn)
            except (TransportError, OSError, pickle.PickleError):
                return
            handler = self._handler
            try:
                if handler is None:
                    raise TransportError("no handler installed")
                reply = handler(msg)
                check_host(reply)
            except Exception as e:          # noqa: BLE001 — ship to caller
                reply = {"_transport_error": f"{type(e).__name__}: {e}"}
            try:
                _send_frame(conn, reply)
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        # shutdown() BEFORE close(): on Linux, close() does not wake a
        # thread blocked in accept() — the listener keeps accepting until
        # one more connection arrives, so a "stopped" host would answer
        # exactly one more request (e.g. falsely confirm a prepare).
        # shutdown() interrupts the blocked accept immediately.
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
