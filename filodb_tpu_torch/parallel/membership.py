"""Elastic membership of the port (the counterpart of
``filodb_tpu.parallel.membership``): planned shard handoff,
rolling-restart drain, and rejoin hand-back.

The crash path (FailureDetector + quorum + ``reassign_dead_shards``)
treats every topology change as a node death: survivors adopt after the
grace window and the returning node gets a hard cutover. This module is
the PLANNED path — FiloDB's ShardManager/ShardAssignmentStrategy moving
shards on node join/leave as a first-class operation (coordinator/
ShardManager.scala:28 assignShardsToNodes; ShardAssignmentStrategy
.scala:188) — built make-before-break per shard on the existing
ordinal/FSM machinery:

Drain (``POST /admin/drain``) hands each locally-served shard to a
designated successor:

  1. **stop the local writer** — the shard's ingestion driver stops and
     flushes through the normal flush path (checkpoints + ColumnStore
     persist), so at most ONE node ever consumes/flushes a shard's
     stream (the per-shard single-writer invariant the chaos suite
     pins);
  2. **adopt request** — the successor is told to adopt over
     ``POST /admin/adopt``; it bootstraps index + chunks from the
     shared ColumnStore and replays the shared stream log from the
     checkpoint watermark (the same ``_adopt_shard`` path crash
     recovery uses), holding the shard RECOVERY;
  3. **await ACTIVE** — the draining node polls the successor's health
     body (the ``_sync_peer_statuses`` gossip channel) until the shard
     is advertised ``active``; meanwhile it KEEPS serving leaf/pushdown
     traffic for the shard from its (complete) resident state, and the
     successor's planner redirects reads for the mid-replay shard back
     to the draining owner (``handoff_sources``), so no query anywhere
     ever lands on a half-replayed copy;
  4. **flip + release** — ownership flips in the local ShardMapper
     (bumping the topology epoch -> plan/results caches invalidate),
     the transfer is pushed to the remaining peers
     (``POST /admin/transfer``; stale-routing bounce-and-retry covers
     any peer the push misses), and only then is the local copy
     released.

On failure (successor dies mid-replay / never goes ACTIVE) the shard
FALLS BACK: the successor is told to abort, the local ingestion driver
restarts from its checkpoint, and the draining node keeps serving — a
failed handoff degrades to "nothing happened", never to a dark shard.

Join/rejoin closes the ``on_node_up`` hard cutover: a restarting node
probes its peers' health bodies first and DEFERS any of its ordinal
shards a peer still serves (no second writer, no empty-shard window);
the temporary owner's failure detector sees the node healthy and runs
the same handoff primitive in reverse (``handback``), so the shard
replays and flips ACTIVE on its home node before the temporary owner
releases.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.parallel.cluster import reassign_dead_shards
from filodb_tpu_torch.parallel.shardmapper import ShardStatus
from filodb_tpu_torch.query.model import QueryError
from filodb_tpu_torch.testing import chaos

_HANDOFF_SECONDS_HELP = ("Wall seconds per planned shard handoff "
                         "(drain-flush + successor replay + flip + "
                         "release)")


def probe_peer_claims(peers: Dict[str, str], shards: Sequence[int],
                      timeout_s: float = 2.0
                      ) -> Dict[int, Tuple[str, str]]:
    """Ask each peer's health body which of ``shards`` it currently
    serves: {shard: (claiming node, advertised status)}. A restarting
    node calls this BEFORE creating its ordinal shards — any shard a
    peer still serves (it adopted it while we were down) is deferred
    until the peer hands it back, closing the dual-writer window a
    blind startup would open. Unreachable peers claim nothing (first
    boot / full-cluster cold start degrade to the normal startup)."""
    claims: Dict[int, Tuple[str, str]] = {}
    want = set(int(s) for s in shards)
    for node, url in sorted(peers.items()):
        try:
            with urllib.request.urlopen(
                    f"{url.rstrip('/')}/__health",
                    timeout=timeout_s) as r:
                body = json.loads(r.read())
        except (OSError, ValueError):
            continue
        for k, st in (body.get("shards") or {}).items():
            try:
                sh = int(k)
            except (TypeError, ValueError):
                continue
            if sh in want and st in ("active", "recovery") \
                    and sh not in claims:
                claims[sh] = (node, st)
    return claims


@guarded_by("_lock", "draining", "incoming", "_cancel_owner",
            "handoffs_started", "handoffs_completed", "handoffs_failed",
            "adoptions_planned", "adoptions_crash", "releases",
            "handback_failures")
class MembershipManager:
    """Planned-membership coordinator for one FiloServer node.

    Owns the per-node handoff state machine and counters; the HTTP
    layer exposes its admin endpoints and /metrics families. All
    mutable state rides ``_lock``; the long-running protocol legs
    (flush, replay await, peer POSTs) run strictly outside it."""

    def __init__(self, server: "FiloServer",  # noqa: F821 — typing only
                 handoff_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.1):
        self.server = server
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self._lock = threading.Lock()
        self.draining = False
        # shard -> "bootstrapping" | "cancelled": planned adoptions in
        # flight on THIS node (the successor side)
        self.incoming: Dict[int, str] = {}
        # shard -> node to restore ownership to when an adoption is
        # aborted (the rolling-back draining owner)
        self._cancel_owner: Dict[int, str] = {}
        self.handoffs_started = 0
        self.handoffs_completed = 0
        self.handoffs_failed = 0
        self.adoptions_planned = 0
        self.adoptions_crash = 0        # bumped by the crash-adopt path
        self.releases = 0
        self.handback_failures = 0

    # -- introspection -----------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "draining": 1 if self.draining else 0,
                "incoming": len(self.incoming),
                "handoffs_started": self.handoffs_started,
                "handoffs_completed": self.handoffs_completed,
                "handoffs_failed": self.handoffs_failed,
                "adoptions_planned": self.adoptions_planned,
                "adoptions_crash": self.adoptions_crash,
                "releases": self.releases,
                "handback_failures": self.handback_failures,
            }

    def note_crash_adoption(self) -> None:
        with self._lock:
            self.adoptions_crash += 1

    def note_release(self) -> None:
        with self._lock:
            self.releases += 1

    # -- the drain/leave side ---------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> Dict:
        """Walk every locally-served shard through planned handoff.
        Synchronous: returns when each shard is either handed off or
        rolled back (the rolling-restart runbook curls this, then stops
        the process). Successors follow the same deterministic
        round-robin the crash path uses, so a later crash of the
        drained node reassigns nothing twice."""
        srv = self.server
        with self._lock:
            already = self.draining
            self.draining = True
        det = getattr(srv, "detector", None)
        alive = sorted(det.alive_peers()) if det is not None \
            else sorted(srv.http.peers)
        if not alive:
            with self._lock:
                self.draining = False
            raise QueryError("drain: no alive peer to hand shards to")
        mine = sorted(n for n in srv.mapper.shards_for_node(srv.node_id)
                      if n in self._local_shard_nums())
        table = reassign_dead_shards(mine, alive)
        out = {"node": srv.node_id, "handed_off": [], "failed": [],
               "already_draining": already}
        for sh, succ in sorted(table.items()):
            ok, err = self.handoff_shard(sh, succ, timeout_s=timeout_s)
            if ok:
                out["handed_off"].append({"shard": sh, "to": succ})
            else:
                out["failed"].append({"shard": sh, "to": succ,
                                      "error": err})
        return out

    def _local_shard_nums(self) -> List[int]:
        srv = self.server
        return [s.shard_num for s in srv.store.shards(srv.ref)]

    def handoff_shard(self, sh: int, successor: str,
                      timeout_s: Optional[float] = None
                      ) -> Tuple[bool, Optional[str]]:
        """One make-before-break handoff. Returns (ok, error)."""
        srv = self.server
        url = srv.http.peers.get(successor)
        if url is None:
            return False, f"unknown successor {successor!r}"
        with self._lock:
            self.handoffs_started += 1
        timeout_s = self.handoff_timeout_s if timeout_s is None \
            else float(timeout_s)
        t0 = time.monotonic()
        tracer = getattr(srv.http, "tracer", None)
        tr = tracer.start(None) if tracer is not None else None
        had_driver = False
        try:
            with obs_trace.activate(tr), \
                    obs_trace.span("shard-handoff", shard=sh,
                                   node=srv.node_id, to=successor):
                # 1. single-writer: stop + flush the local ingestion
                # driver BEFORE the successor may start its own; the
                # shard's resident state stays queryable
                with obs_trace.span("drain-flush", shard=sh):
                    # registry mutation rides the server's reassign
                    # lock (shared with adopt/release workers); the
                    # stop+flush below runs outside it
                    with srv._reassign_lock:
                        drv = srv.drivers.pop(sh, None)
                    had_driver = drv is not None
                    if drv is not None:
                        drv.stop(flush=True)
                    elif srv.store.column_store is not None:
                        srv.store.get_shard(srv.ref, sh).flush_all()
                # 2. adopt request: the successor bootstraps + replays
                chaos.fire("handoff.adopt", shard=sh, node=successor)
                with obs_trace.span("adopt-request", shard=sh):
                    self._post(url, "/admin/adopt",
                               {"shard": sh, "from": srv.node_id})
                # 3. make-before-break: wait for the successor's health
                # body to advertise the shard ACTIVE
                with obs_trace.span("await-active", shard=sh):
                    self._await_active(url, sh,
                                       deadline=t0 + timeout_s)
                # 4. flip ownership (topology epoch bump -> local
                # plan/results caches invalidate via the mapper event),
                # push the transfer to the remaining peers, release
                srv.mapper.assign(sh, successor)
                srv.mapper.update(sh, ShardStatus.ACTIVE, successor)
                with obs_trace.span("transfer", shard=sh):
                    self._broadcast_transfer(sh, successor)
                with obs_trace.span("release", shard=sh):
                    srv._release_shard(sh)
            with self._lock:
                self.handoffs_completed += 1
            obs_metrics.observe("filodb_shard_handoff_seconds",
                                _HANDOFF_SECONDS_HELP,
                                time.monotonic() - t0)
            return True, None
        except Exception as e:      # noqa: BLE001 — any leg may fail
            with self._lock:
                self.handoffs_failed += 1
            obs_trace.event("handoff-failed", shard=sh, error=str(e))
            # fall back to the draining owner: abort the successor's
            # half-adoption (best effort — it may be dead, which is
            # fine) and restart the local writer from its checkpoint
            try:
                self._post(url, "/admin/abort_adopt",
                           {"shard": sh, "owner": srv.node_id},
                           timeout_s=2.0)
            except (OSError, QueryError):
                pass
            if had_driver:
                try:
                    srv._restart_driver(sh)
                except Exception as e2:     # noqa: BLE001
                    return False, f"{e}; driver restart failed: {e2}"
            return False, str(e)
        finally:
            if tr is not None and tracer is not None:
                tracer.finish(tr)

    def _post(self, base_url: str, path: str, body: Dict,
              timeout_s: float = 10.0) -> Dict:
        req = urllib.request.Request(
            f"{base_url.rstrip('/')}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            payload = json.loads(r.read())
        if payload.get("status") != "success":
            raise QueryError(f"{path} on {base_url}: "
                             f"{payload.get('error')}")
        return payload

    def _await_active(self, url: str, sh: int, deadline: float) -> None:
        last = None
        while time.monotonic() < deadline:
            chaos.fire("handoff.await", shard=sh)
            try:
                with urllib.request.urlopen(
                        f"{url.rstrip('/')}/__health",
                        timeout=2.0) as r:
                    body = json.loads(r.read())
                last = (body.get("shards") or {}).get(str(sh))
                if last == "active":
                    return
            except (OSError, ValueError):
                last = "unreachable"
            time.sleep(self.poll_interval_s)
        raise QueryError(
            f"handoff of shard {sh} timed out waiting for the "
            f"successor to go active (last advertised: {last})")

    def _broadcast_transfer(self, sh: int, owner: str) -> None:
        """Best-effort ownership push to every other alive peer; a peer
        the push misses converges through health gossip or the
        stale-routing bounce-and-retry path."""
        srv = self.server
        det = getattr(srv, "detector", None)
        for node, url in sorted(srv.http.peers.items()):
            if node == owner:
                continue        # the new owner already claims it
            if det is not None and det.is_down(node):
                continue
            try:
                chaos.fire("handoff.transfer", shard=sh, node=node)
                self._post(url, "/admin/transfer",
                           {"shard": sh, "owner": owner}, timeout_s=5.0)
            except (OSError, QueryError):
                pass

    # -- the successor / adopt side ---------------------------------------
    def accept_adopt(self, sh: int, from_node: str) -> Dict:
        """Successor side of a handoff (also the hand-back receiver on
        rejoin): bootstrap + replay in the background, redirecting
        reads for the mid-replay shard to the previous owner until the
        ingestion driver flips it ACTIVE."""
        srv = self.server
        sh = int(sh)
        if sh < 0 or sh >= srv.mapper.num_shards:
            raise QueryError(f"adopt: shard {sh} out of range")
        with self._lock:
            state = self.incoming.get(sh)
            if state == "bootstrapping":
                return {"state": "bootstrapping"}
            if sh in srv.drivers or sh in self._local_shard_nums():
                return {"state": "active"}
            self.incoming[sh] = "bootstrapping"
            self.adoptions_planned += 1
        # reads for the shard route back to the still-serving previous
        # owner while we replay (cleared when the driver goes ACTIVE).
        # All handoff_sources mutations ride _lock: the redirect map is
        # shared with the adopt/reaper worker threads
        if from_node in srv.http.peers:
            with self._lock:
                srv.http.handoff_sources[sh] = from_node
        with srv._reassign_lock:
            # remember whose shard this was, so when the node returns
            # (rejoin after drain+restart) the same handoff primitive
            # hands it back
            lst = srv._adopted.setdefault(from_node, [])
            if sh not in lst:
                lst.append(sh)
        threading.Thread(target=self._adopt_run, args=(sh, from_node),
                         daemon=True, name=f"adopt-shard-{sh}").start()
        return {"state": "accepted"}

    def _register_adopt_driver(self, sh: int, drv) -> bool:
        """Single-writer gate for a planned adoption's replay driver:
        registration and abort-cancellation are serialized on ``_lock``
        — an abort that lands mid-bootstrap refuses the registration,
        so the driver never starts after the draining owner has
        resumed ingesting."""
        with self._lock:
            if self.incoming.get(sh) == "cancelled":
                return False
            # nested per the canonical order (membership gate outer,
            # server registry inner)
            with self.server._reassign_lock:
                self.server.drivers[sh] = drv
        return True

    @thread_root("adopt-shard")
    def _adopt_run(self, sh: int, from_node: str) -> None:
        srv = self.server
        try:
            srv._adopt_shard(
                sh, on_event=self._adopt_event,
                register=lambda drv: self._register_adopt_driver(
                    sh, drv))
        except Exception:       # noqa: BLE001 — surfaced as shard ERROR
            with self._lock:
                srv.http.handoff_sources.pop(sh, None)
                self.incoming.pop(sh, None)
            srv._release_shard(sh)
            srv.mapper.update(sh, ShardStatus.ERROR, srv.node_id)
            return
        with self._lock:
            cancelled = self.incoming.get(sh) == "cancelled"
        if cancelled or sh not in srv.drivers:
            # no streaming driver (or an abort raced the bootstrap):
            # finalize inline — _adopt_shard already flipped ACTIVE on
            # the no-driver path
            self._finalize_adopt(sh, cancelled=cancelled)

    def _adopt_event(self, sh: int, status: ShardStatus,
                     progress: int) -> None:
        """Ingestion-driver event hook for planned adoptions: when the
        replay completes (ACTIVE), clear the read redirect — from here
        on this node serves the shard itself."""
        if status is ShardStatus.ACTIVE:
            with self._lock:
                cancelled = self.incoming.get(sh) == "cancelled"
            # release must not run on the driver's own thread (stop()
            # would join it); hand cancellation to a reaper thread
            if cancelled:
                threading.Thread(
                    target=self._finalize_adopt, args=(sh, True),
                    daemon=True, name=f"abort-adopt-{sh}").start()
            else:
                self._finalize_adopt(sh, cancelled=False)

    @thread_root("abort-adopt-reaper")
    def _finalize_adopt(self, sh: int, cancelled: bool) -> None:
        srv = self.server
        with self._lock:
            srv.http.handoff_sources.pop(sh, None)
            self.incoming.pop(sh, None)
            owner = self._cancel_owner.pop(sh, None)
        if cancelled:
            srv._release_shard(sh)
            self._restore_owner(sh, owner)

    def _restore_owner(self, sh: int, owner: Optional[str]) -> None:
        """An aborted adoption leaves the local mapper claiming a shard
        this node no longer serves — point it back at the rolled-back
        owner (it kept serving throughout)."""
        srv = self.server
        if owner and owner != srv.node_id and owner in srv.http.peers:
            srv.mapper.assign(sh, owner)
            srv.mapper.update(sh, ShardStatus.ACTIVE, owner)

    def abort_adopt(self, sh: int, owner: str = "") -> Dict:
        """The draining owner rolled back (we never went ACTIVE in
        time, or it chose to): drop the half-adopted state so two
        writers never run, and return the mapper claim to ``owner``.
        Safe at any point of the adopt."""
        srv = self.server
        sh = int(sh)
        with self._lock:
            state = self.incoming.get(sh)
            if state is not None:
                self.incoming[sh] = "cancelled"
                if owner:
                    self._cancel_owner[sh] = owner
            # popped under the SAME lock the registration gate takes:
            # either the replay driver registered first (we stop it
            # below) or the gate will refuse it — no interleaving
            # leaves a writer running after the rollback
            with srv._reassign_lock:
                drv = srv.drivers.pop(sh, None)
            srv.http.handoff_sources.pop(sh, None)
        if drv is not None:
            drv.stop(flush=False)
            srv._release_shard(sh)
            with self._lock:
                self.incoming.pop(sh, None)
                self._cancel_owner.pop(sh, None)
            self._restore_owner(sh, owner)
            return {"state": "released"}
        if state is None and sh in self._local_shard_nums():
            # adoption already finalized with no driver (non-streaming)
            srv._release_shard(sh)
            self._restore_owner(sh, owner)
            return {"state": "released"}
        return {"state": "cancelled" if state is not None else "noop"}

    def apply_transfer(self, sh: int, owner: str) -> Dict:
        """A peer completed a handoff: rewire shard -> owner locally
        (bumping the topology epoch; the mapper event invalidates the
        plan/results caches)."""
        srv = self.server
        sh = int(sh)
        if sh < 0 or sh >= srv.mapper.num_shards:
            raise QueryError(f"transfer: shard {sh} out of range")
        if owner != srv.node_id and owner not in srv.http.peers:
            raise QueryError(f"transfer: unknown owner {owner!r}")
        if srv.mapper.node_of(sh) != owner:
            srv.mapper.assign(sh, owner)
            srv.mapper.update(sh, ShardStatus.ACTIVE, owner)
            return {"applied": True}
        return {"applied": False}

    # -- the rejoin / hand-back side --------------------------------------
    def handback(self, node: str) -> None:
        """A node this one adopted shards from is healthy again: hand
        each shard back through the SAME make-before-break handoff
        (replacing the legacy hard cutover). Runs in the background —
        the failure detector's poll thread must keep polling. Per-shard
        retries cover the returning node's startup window (its admin
        endpoints may answer a beat after its health does)."""
        with self.server._reassign_lock:
            mine = list(self.server._adopted.pop(node, []))
        if not mine:
            return
        threading.Thread(target=self._handback_run, args=(node, mine),
                         daemon=True, name=f"handback-{node}").start()

    @thread_root("handback")
    def _handback_run(self, node: str, shards: List[int]) -> None:
        for sh in sorted(shards):
            ok = False
            for attempt in range(3):
                ok, _err = self.handoff_shard(sh, node)
                if ok:
                    break
                time.sleep(0.5 * (attempt + 1))
            if not ok:
                # the shard stays HERE (still served, still single-
                # writer); re-record it so a later recovery can retry
                with self.server._reassign_lock:
                    lst = self.server._adopted.setdefault(node, [])
                    if sh not in lst:
                        lst.append(sh)
                with self._lock:
                    self.handback_failures += 1
