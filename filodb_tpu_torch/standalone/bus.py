"""Local control plane for the process-sharded serving tier (the
counterpart of ``filodb_tpu.standalone.bus``; the same JSON-lines wire,
so a hub and a client of either package talk to each other).

One supervisor process owns N query-worker processes on a host
(``standalone/supervisor.py``). Worker caches are per-process (plan,
results, device tiles), so cache-coherence events that used to be a
single in-process subscriber hop — ShardMapper topology transitions,
schema invalidations, ingest-watermark/backfill gossip — need a local
plane to reach every sibling interpreter. That plane is this bus: a
loopback JSON-lines hub. Each worker holds one connection to the
supervisor; an event published by any worker (or by the supervisor
itself) is fanned out to every OTHER worker, which applies it to its
local mapper/caches.

Why not rely on the existing health-body gossip alone? The failure
detector polls at ``failure-detect-interval-s`` (default 0.5s) — a
topology flip would leave sibling caches serving extents keyed on the
old world for up to a full poll. The bus delivers the invalidation in
the same millisecond the transition commits, host-locally, with the
detector gossip remaining the (cross-host) backstop.

Event shapes (one JSON object per line):

  {"type": "hello", "worker": 0, "node": "node0"}      worker handshake
  {"type": "topology", "origin": "node0", "shard": 3,
   "status": "active", "node": "node1", "epoch": 7}    mapper transition
  {"type": "schema", "origin": "node0", "reason": "…"} plan/results drop
  {"type": "watermarks", "origin": "node0",
   "watermarks": {...}, "backfill_epochs": {...},
   "topo_epoch": 7}                                    freshness gossip
  {"type": "worker-exit", "node": "node1"}             supervisor hint
  {"type": "worker-up", "node": "node1"}               supervisor hint

The protocol is deliberately at-most-once / fire-and-forget: every
event is an *idempotent hint* (invalidate, update a sink) and the
detector's periodic gossip re-converges anything a dropped connection
missed.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root


def _send_line(sock: socket.socket, lock: threading.Lock,
               event: Dict) -> bool:
    """One JSON line onto a connection; False on any transport error
    (the caller drops/reconnects — events are idempotent hints)."""
    data = (json.dumps(event, separators=(",", ":")) + "\n").encode()
    try:
        with lock:
            sock.sendall(data)
        return True
    except OSError:
        return False


@guarded_by("_lock", "_conns", "events_seen", "topo_epochs")
class SupervisorBus:
    """The hub: accepts one connection per worker, fans every received
    event out to all OTHER workers, and lets the supervisor broadcast
    its own events (worker lifecycle hints, operator-initiated schema
    invalidations)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port), backlog=64)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        # conn id -> (sock, send lock, worker id or None)
        self._conns: Dict[int, tuple] = {}
        self._next_id = 0
        self._closed = threading.Event()
        self.events_seen = 0
        # supervisor-side view fed by worker events (observability):
        # last topology epoch each worker reported
        self.topo_epochs: Dict[str, int] = {}
        self._accept_thread = threading.Thread(
            target=self._accept_run, daemon=True, name="bus-accept")

    def start(self) -> "SupervisorBus":
        self._accept_thread.start()
        return self

    @thread_root("bus-accept")
    def _accept_run(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return              # closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = self._next_id
                self._next_id += 1
                self._conns[cid] = (conn, threading.Lock(), None)
            threading.Thread(target=self._reader_run, args=(cid, conn),
                             daemon=True,
                             name=f"bus-reader-{cid}").start()

    @thread_root("bus-reader")
    def _reader_run(self, cid: int, conn: socket.socket) -> None:
        try:
            f = conn.makefile("rb")
            for raw in f:
                try:
                    ev = json.loads(raw)
                except ValueError:
                    continue
                with self._lock:
                    self.events_seen += 1
                if ev.get("type") == "hello":
                    with self._lock:
                        sock, lk, _ = self._conns[cid]
                        self._conns[cid] = (sock, lk, ev.get("worker"))
                    continue
                if ev.get("type") == "watermarks" \
                        and ev.get("origin"):
                    with self._lock:
                        self.topo_epochs[str(ev["origin"])] = \
                            int(ev.get("topo_epoch") or 0)
                self._fanout(ev, exclude=cid)
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.pop(cid, None)
            try:
                conn.close()
            except OSError:
                pass

    def _fanout(self, event: Dict, exclude: Optional[int] = None
                ) -> None:
        with self._lock:
            targets = [(cid, sock, lk) for cid, (sock, lk, _w)
                       in self._conns.items() if cid != exclude]
        for cid, sock, lk in targets:
            if not _send_line(sock, lk, event):
                with self._lock:
                    self._conns.pop(cid, None)

    def broadcast(self, event: Dict) -> None:
        """Supervisor-originated event to every connected worker."""
        self._fanout(event, exclude=None)

    def connected_workers(self) -> List:
        with self._lock:
            return sorted(w for _s, _l, w in self._conns.values()
                          if w is not None)

    def stop(self) -> None:
        self._closed.set()
        try:
            # wakes the accept thread: a close alone leaves its blocked
            # accept() holding the listener, which takes new connections
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock, _lk, _w in conns:
            try:
                # the reader's file object keeps the descriptor open past
                # close(): a shutdown ends the connection for both ends
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


@guarded_by("_lock", "_sock", "published", "applied", "reconnects")
class BusClient:
    """A worker's end of the control plane: one loopback connection to
    the supervisor's hub, a reader loop applying inbound events through
    registered handlers, and ``publish()`` for local events. Reconnects
    with backoff — the bus is a latency optimization over detector
    gossip, so a dead supervisor degrades coherence latency, never
    correctness."""

    def __init__(self, port: int, worker_id: int, node_id: str,
                 host: str = "127.0.0.1"):
        self.host = host
        self.port = int(port)
        self.worker_id = int(worker_id)
        self.node_id = node_id
        self._handlers: Dict[str, Callable[[Dict], None]] = {}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self.published = 0
        self.applied = 0
        self.reconnects = 0
        # reentrancy guard: events APPLIED from the bus may trigger the
        # same local subscribers that normally PUBLISH to the bus (a
        # mapper transition applied from a sibling fires this worker's
        # mapper subscriber); per-thread, so concurrent local
        # transitions on other threads still publish
        self._applying = threading.local()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"bus-client-{worker_id}")

    # -- wiring -----------------------------------------------------------
    def on(self, event_type: str,
           handler: Callable[[Dict], None]) -> "BusClient":
        self._handlers[event_type] = handler
        return self

    def start(self) -> "BusClient":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            sock = self._sock
            self._sock = None
        if sock is not None:
            try:
                # a shutdown wakes the reader blocked on this socket; a
                # close alone leaves it (and the descriptor its file
                # object holds) waiting until the join times out
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5)

    @property
    def applying(self) -> bool:
        """True on the reader thread while a bus event is being applied
        (publishers consult this to break the apply→republish loop)."""
        return bool(getattr(self._applying, "flag", False))

    # -- outbound ---------------------------------------------------------
    def publish(self, event: Dict) -> None:
        """Fire-and-forget: a transport failure just drops the event
        (detector gossip re-converges) and lets the reader loop
        reconnect."""
        if self.applying:
            return          # this event originated from the bus itself
        event.setdefault("origin", self.node_id)
        with self._lock:
            sock = self._sock
        if sock is None:
            return
        if _send_line(sock, self._send_lock, event):
            with self._lock:
                self.published += 1
        else:
            self._drop_sock(sock)

    def _drop_sock(self, sock) -> None:
        with self._lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass

    # -- reader loop ------------------------------------------------------
    @thread_root("bus-client")
    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=5)
            except OSError:
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._sock = sock
                self.reconnects += 1
            _send_line(sock, self._send_lock,
                       {"type": "hello", "worker": self.worker_id,
                        "node": self.node_id})
            backoff = 0.05
            try:
                f = sock.makefile("rb")
                for raw in f:
                    if self._stop.is_set():
                        break
                    try:
                        ev = json.loads(raw)
                    except ValueError:
                        continue
                    self._apply(ev)
            except OSError:
                pass
            self._drop_sock(sock)

    def _apply(self, ev: Dict) -> None:
        handler = self._handlers.get(str(ev.get("type")))
        if handler is None:
            return
        self._applying.flag = True
        try:
            handler(ev)
            with self._lock:
                self.applied += 1
        except Exception:   # noqa: BLE001 — a bad event must not kill
            pass            # the reader loop; events are hints
        finally:
            self._applying.flag = False

    @property
    def connected(self) -> bool:
        with self._lock:
            return self._sock is not None

    def metrics_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"published": self.published,
                    "applied": self.applied,
                    # first successful connect counts in reconnects;
                    # report re-dials only
                    "reconnects": max(0, self.reconnects - 1),
                    "connected": 1 if self._sock is not None else 0}


def wait_connected(client: BusClient, timeout_s: float = 5.0) -> bool:
    """Test/startup helper: block until the client's first connect (or
    timeout). The bus stays best-effort afterwards."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if client.connected:
            return True
        time.sleep(0.01)
    return client.connected
