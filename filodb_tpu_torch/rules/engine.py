"""In-process continuous-query engine: recording rules and alerting (the
counterpart of ``filodb_tpu.rules.engine``).

The reference system is PromQL-compatible but defers rules and alerting
to an external ruler. This engine leapfrogs that: rule groups evaluate
*inside* the node as standing queries through the NORMAL
planner/engine/QoS path, so every piece of serving machinery the repo
has grown — plan cache, incremental results cache, cost-based
admission, priority micro-batching, degraded-mode fan-out — applies to
rule evaluation for free, and every dashboard query a recording rule
precomputes converts per-user traffic into O(rules) background work.

Design points:

* **Step-aligned tail recomputes** — each group tick evaluates its
  rules as a RANGE query over the last ``span_steps`` interval-aligned
  steps ending at the tick boundary, not as an isolated instant query.
  Consecutive ticks therefore share the same results-cache key (same
  text, same step, same grid phase) and the cache serves the warm
  prefix; only the newest step computes. The tick's sample is the last
  grid column.

* **QoS** — evaluations run under the reserved ``__rules__`` tenant:
  BACKGROUND priority (the micro-batcher never lets a rule scan
  head-of-line block an interactive query) and FORCED charges (rule
  evaluation must never bounce off a drained admission bucket — the
  standing workload keeps evaluating through brownouts, visibly driving
  its bucket into debt instead of silently pausing).

* **Write-back** — recorded series and the synthetic ``ALERTS`` /
  ``ALERTS_FOR_STATE`` state series re-enter through the shared
  :class:`~filodb_tpu_torch.obs.writeback.IngestWriteBack` rail into the
  reserved ``__rules__`` dataset (strictly node-local planner, own
  cardinality tracker, durable WAL + driver replay under ``stream-dir``
  — recorded series survive restarts).

* **Single-owner scheduling** — under the worker supervisor exactly ONE
  worker evaluates: the lowest ALIVE ordinal. Every worker loads the
  (supervisor-propagated) rules config; non-evaluators stand by and
  re-elect on the bus ``worker-exit``/``worker-up`` lifecycle events.
  A newly-activated evaluator SKIPS the in-progress boundary (its
  predecessor is assumed to have run it) and owns the next one — no
  duplicated tick by construction, no missed tick as long as failover
  completes within one interval.

* **First-class rule observability** — per-rule eval/failure counters,
  the ``filodb_rule_tick_seconds`` duty-cycle histogram, per-group
  staleness gauges (rising staleness = the alerter itself is in
  trouble), alert-state gauges and transition counters all ride the
  metrics registry — so with ``--self-monitor`` on,
  ``rate(filodb_rule_eval_failures_total[5m])`` is a PromQL query over
  ``/promql/__selfmon__``: alerting on the alerter works. The last
  evaluation (query, range, cache dispositions, duration, error) is
  retained per rule and surfaced through ``/api/v1/rules`` with
  ``&explain=analyze``; alert state transitions land in a bounded
  structured-event ring on ``/api/v1/alerts``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.lint.caches import cache_registry
from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.engine import lp_replace_range
from filodb_tpu_torch.query.model import GridResult, ScalarResult
from filodb_tpu_torch.query.plancache import _cacheable
from filodb_tpu_torch.query.qos import RULES_TENANT
from filodb_tpu_torch.rules.loader import Rule, RuleGroup

# the reserved internal dataset recorded series and alert-state series
# are written into (strictly node-local, like __selfmon__); its name
# doubles as the reserved tenant rule evaluation runs under
RULES_DATASET = RULES_TENANT

# alert states (Prometheus rule-state names)
STATE_INACTIVE = "inactive"
STATE_PENDING = "pending"
STATE_FIRING = "firing"

_TICK_HELP = "Wall seconds per rule-group evaluation tick"
_EVAL_HELP = "Wall seconds per single rule evaluation"

# labels the source result carries that must not leak into the
# recorded series identity (re-tagged into the internal dataset)
_RESERVED_LABELS = ("_ws_", "_ns_", "_metric_")


def _render_template(text: str, value, labels: Dict[str, str]) -> str:
    """Minimal annotation templating: ``{{ $value }}`` and
    ``{{ $labels.<name> }}`` (the two forms alert annotations actually
    use; anything else passes through verbatim)."""
    import re
    if "{{" not in text:
        return text
    out = re.sub(r"\{\{\s*\$value\s*\}\}",
                 ("" if value is None else f"{value:g}"), text)
    return re.sub(
        r"\{\{\s*\$labels\.([a-zA-Z_][a-zA-Z0-9_]*)\s*\}\}",
        lambda m: str(labels.get(m.group(1), "")), out)


# inventory declaration: the per-rule parsed-plan cache is topology- and
# schema-dependent exactly like the server's PlanCache (the evaluation
# range is rebased out of the key) — every @publishes of these events
# must reach `invalidate_plans` through the plan cache's listener chain
# (the standalone server registers it with add_invalidation_listener).
@cache_registry("rule-plans",
                invalidated_by={"topology-epoch": "invalidate_plans",
                                "schema": "invalidate_plans"},
                keyed=("dataset", "query-text", "step"))
@guarded_by("_lock", "_plan_cache", "_alive", "_last_run", "_rule_state",
            "_alerts", "_transitions", "_group_state", "active",
            "_announced", "_final_until", "_election_log", "ticks",
            "errors", "plan_invalidations", "notifications_enqueued")
class RulesEngine:
    """The per-process rules scheduler (a declared thread root).

    ``evaluator(ds, query, plan, start_ms, step_ms, end_ms)`` runs one
    standing-query evaluation through the serving path and returns
    ``(result, stages)`` — the HTTP server's ``rule_eval_range`` in
    production, a stub in unit tests. ``writeback`` is this engine's
    own :class:`~filodb_tpu_torch.obs.writeback.IngestWriteBack` into the
    reserved rules dataset."""

    def __init__(self, groups: Sequence[RuleGroup],
                 evaluator: Callable,
                 writeback,
                 default_dataset: str = "timeseries",
                 node: str = "", worker_id: Optional[int] = None,
                 num_workers: int = 1,
                 span_steps: int = 8,
                 notifier=None,
                 announced: bool = True,
                 clock: Callable[[], float] = time.time):
        self.groups: Tuple[RuleGroup, ...] = tuple(groups)
        self.evaluator = evaluator
        self.writeback = writeback
        self.default_dataset = default_dataset
        self.node = node or ""
        self.worker_id = worker_id
        self.num_workers = max(1, int(num_workers))
        self.span_steps = max(2, int(span_steps))
        self.notifier = notifier
        self._clock = clock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._lock = threading.Lock()
        # election: ordinals believed alive (supervisor fleet); the
        # evaluator is the lowest ALIVE *announced* ordinal. A
        # standalone process (worker_id None, or no bus) is announced
        # from birth; a supervised worker stays in standby until its
        # OWN ``worker-up`` broadcast arrives — the same fan-out that
        # tells the stand-in to step down, so a restarting ordinal 0
        # reclaims evaluation in one bus beat instead of racing the
        # stand-in through a half-second double-evaluation window.
        self._ordinal = int(worker_id) if worker_id is not None else 0
        self._alive = set(range(self.num_workers)) \
            if worker_id is not None else {0}
        self._announced = bool(announced) or worker_id is None
        self.active = self._announced \
            and self._ordinal == min(self._alive)
        # per-group scheduling state: group name -> last evaluated (or
        # claimed) boundary. Activation stamps the CURRENT boundary
        # per group (the predecessor is assumed to have run it — no
        # duplicated tick); deactivation leaves it in place and arms a
        # bounded final catch-up pass (see evaluate_due) so a boundary
        # that fell due in the handover beat is not missed.
        self._last_run: Dict[str, float] = {}
        self._final_until: Optional[float] = None
        # per-group health: last tick wall time/duration, last success
        self._group_state: Dict[str, Dict] = {}
        # per-rule runtime state: (group, rule) -> {health, last_error,
        # last_eval {...}}
        self._rule_state: Dict[Tuple[str, str], Dict] = {}
        # alert instances: (group, rule) -> {inst_key: {...}}
        self._alerts: Dict[Tuple[str, str], Dict[Tuple, Dict]] = {}
        # bounded structured-event ring of alert state transitions
        self._transitions: deque = deque(maxlen=256)
        # bounded election-event ring (activations, step-downs, the
        # alive-set edges that caused them) — the failover audit trail
        self._election_log: deque = deque(maxlen=64)
        # parsed-plan cache (see the registry declaration above)
        self._plan_cache: Dict[Tuple, object] = {}
        self.ticks = 0
        self.errors = 0
        self.plan_invalidations = 0
        self.notifications_enqueued = 0
        # scheduler poll cadence: fine enough for the smallest interval
        min_iv = min((g.interval_s for g in self.groups), default=60.0)
        self._poll_s = max(0.02, min(0.25, min_iv / 8.0))
        reg = obs_metrics.GLOBAL_REGISTRY
        self._m_evals = reg.counter(
            "filodb_rule_evals_total",
            "Rule evaluations completed, by group and rule")
        self._m_failures = reg.counter(
            "filodb_rule_eval_failures_total",
            "Rule evaluations that raised (state is kept, alerts do "
            "not flap on an evaluation failure)")
        self._m_ticks = reg.counter(
            "filodb_rule_group_ticks_total",
            "Rule-group evaluation ticks completed")
        self._m_missed = reg.counter(
            "filodb_rule_group_ticks_missed_total",
            "Interval boundaries skipped because the previous tick "
            "overran (the skipped-evaluation signal)")
        self._m_samples = reg.counter(
            "filodb_rule_samples_written_total",
            "Derived samples written back by the rules engine")
        self._m_transitions = reg.counter(
            "filodb_alert_transitions_total",
            "Alert state transitions, by alertname and target state")
        self._m_active = reg.gauge(
            "filodb_rules_active",
            "1 while THIS process is the elected rule evaluator")
        self._m_interval = reg.gauge(
            "filodb_rule_group_interval_seconds",
            "Configured per-group evaluation interval")
        self._m_rules = reg.gauge(
            "filodb_rule_group_rules",
            "Rules per group")
        self._m_duration = reg.gauge(
            "filodb_rule_group_last_duration_seconds",
            "Wall seconds of the group's last evaluation tick")
        self._m_staleness = reg.gauge(
            "filodb_rule_group_staleness_seconds",
            "Seconds since the group's last SUCCESSFUL evaluation "
            "(rising = the rules engine itself is in trouble)")
        self._m_alerts = reg.gauge(
            "filodb_alerts",
            "Active alert instances by alertname and state")
        reg.register_collector(self._collect)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RulesEngine":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rules-scheduler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        self._stopped = True
        if self._thread is not None:
            self._thread.join(timeout)
        if self.notifier is not None:
            self.notifier.stop(timeout)
        obs_metrics.GLOBAL_REGISTRY.unregister_collector(self._collect)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @thread_root("rules-scheduler")
    def _run(self) -> None:
        while not self._stop_evt.wait(self._poll_s):
            try:
                self.evaluate_due()
            except Exception:   # noqa: BLE001 — the scheduler must not die
                with self._lock:
                    self.errors += 1

    # -- election (single-owner scheduling under the supervisor) ----------
    def note_worker_exit(self, ordinal: int) -> None:
        """Bus ``worker-exit``: a sibling worker process is GONE. If it
        was the evaluator, the next-lowest ordinal takes over."""
        with self._lock:
            self._alive.discard(int(ordinal))
            self._election_log.append(
                {"at": self._clock(), "event": "worker-exit",
                 "ordinal": int(ordinal)})
        self._recompute_active()

    def note_worker_up(self, ordinal: int) -> None:
        """Bus ``worker-up``: a worker is serving. Our OWN event is the
        activation edge (the supervisor announced us to the fleet); a
        returning lower ordinal's event makes the stand-in step down
        before its next boundary."""
        with self._lock:
            if 0 <= int(ordinal) < self.num_workers:
                self._alive.add(int(ordinal))
            if int(ordinal) == self._ordinal:
                self._announced = True
            self._election_log.append(
                {"at": self._clock(), "event": "worker-up",
                 "ordinal": int(ordinal)})
        self._recompute_active()

    def evaluator_ordinal(self) -> int:
        with self._lock:
            return min(self._alive) if self._alive else self._ordinal

    def _recompute_active(self) -> None:
        now = self._clock()
        with self._lock:
            alive = self._alive or {self._ordinal}
            act = self._announced and self._ordinal == min(alive)
            changed = act != self.active
            self.active = act
            if changed and act:
                # taking over: claim the CURRENT boundary of every
                # group AT THE ELECTION INSTANT (the same bus beat that
                # steps the predecessor down), so the two schedules
                # partition the boundary walk with no overlap — the
                # predecessor owns everything up to this beat, we own
                # everything after it
                self._final_until = None
                for g in self.groups:
                    self._last_run[g.name] = \
                        math.floor(now / g.interval_s) * g.interval_s
            elif changed and not act:
                # stepping down: arm ONE bounded catch-up pass — a
                # boundary that fell due before this beat but was not
                # yet evaluated (scheduler-poll race) is still ours;
                # everything after the beat belongs to the successor
                self._final_until = now
            if changed:
                self._election_log.append(
                    {"at": now,
                     "event": "activated" if act else "stepped-down",
                     "alive": sorted(alive)})
        if changed:
            obs_trace.event("rules-election", active=act,
                            ordinal=self._ordinal)

    # -- scheduling --------------------------------------------------------
    def evaluate_due(self, now_s: Optional[float] = None) -> int:
        """Evaluate every group whose interval boundary has passed;
        returns the number of group ticks run. Public so tests can
        drive deterministic clocks. A group's FIRST due check after
        (re)activation only claims the current boundary — the previous
        evaluator is assumed to have run it (no duplicated tick)."""
        now = self._clock() if now_s is None else float(now_s)
        with self._lock:
            active = self.active
            final_until = self._final_until
        if not active:
            if final_until is None:
                return 0
            # the step-down catch-up: evaluate boundaries that fell
            # due BEFORE the handover beat but had not run yet (the
            # successor claimed everything after the beat), then
            # retire the schedule
            ran = self._run_due(min(now, final_until))
            with self._lock:
                self._final_until = None
                self._last_run.clear()
            return ran
        return self._run_due(now)

    def _run_due(self, now: float) -> int:
        ran = 0
        for g in self.groups:
            boundary = math.floor(now / g.interval_s) * g.interval_s
            with self._lock:
                last = self._last_run.get(g.name)
                if last is None:
                    self._last_run[g.name] = boundary
                    continue
                if boundary <= last:
                    continue
                missed = int(round((boundary - last) / g.interval_s)) - 1
            if missed > 0:
                self._m_missed.inc(missed, group=g.name)
            self.eval_group_once(g, boundary)
            with self._lock:
                self._last_run[g.name] = boundary
            ran += 1
        return ran

    # -- one group tick ----------------------------------------------------
    def eval_group_once(self, group: RuleGroup, at_s: float) -> Dict:
        """Evaluate one group at the aligned boundary ``at_s``: every
        rule runs as a step-aligned tail recompute, recorded/alert
        samples write back through the rail, per-rule state updates.
        Public for tests (deterministic manual ticks)."""
        t0 = time.perf_counter()
        ds = group.dataset or self.default_dataset
        step_ms = max(1, int(round(group.interval_s * 1000)))
        end_ms = int(round(at_s * 1000))
        # keep the grid phase constant across ticks: consecutive ticks
        # share the results-cache key and only the tail recomputes
        end_ms -= end_ms % step_ms
        start_ms = end_ms - (self.span_steps - 1) * step_ms
        samples: List[Tuple[str, Dict, int, float]] = []
        ok = True
        for rule in group.rules:
            t1 = time.perf_counter()
            err: Optional[str] = None
            stages: Dict[str, object] = {}
            n_out = 0
            try:
                plan, pc_state = self._plan_for(ds, rule.expr, start_ms,
                                                step_ms, end_ms)
                res, stages = self.evaluator(ds, rule.expr, plan,
                                             start_ms, step_ms, end_ms)
                stages = dict(stages or {})
                stages["rulePlanCache"] = pc_state
                last_col = self._last_column(res, group, rule)
                if rule.is_alert:
                    n_out = self._apply_alert_state(
                        group, rule, last_col, at_s, samples)
                else:
                    n_out = self._record_samples(
                        group, rule, last_col, end_ms, samples)
            except Exception as e:   # noqa: BLE001 — one rule must not
                err = f"{type(e).__name__}: {e}"     # kill the group
                ok = False
                self._m_failures.inc(group=group.name, rule=rule.name)
            dt = time.perf_counter() - t1
            self._m_evals.inc(group=group.name, rule=rule.name)
            obs_metrics.observe("filodb_rule_eval_seconds", _EVAL_HELP,
                                dt)
            with self._lock:
                self._rule_state[(group.name, rule.name)] = {
                    "health": "err" if err else "ok",
                    "last_error": err,
                    "last_eval": {
                        "at": at_s,
                        "duration_s": round(dt, 6),
                        "query": rule.expr,
                        "dataset": ds,
                        "start_ms": start_ms,
                        "step_ms": step_ms,
                        "end_ms": end_ms,
                        "samples": n_out,
                        "stages": stages,
                    },
                }
        written = 0
        if samples:
            try:
                written = self.writeback.write(samples)
                self.writeback.flush()
            except Exception:   # noqa: BLE001 — write-back failure is a
                ok = False      # tick failure, not a crash
                self._m_failures.inc(group=group.name,
                                     rule="__writeback__")
        if written:
            self._m_samples.inc(written, group=group.name)
        dt_group = time.perf_counter() - t0
        self._m_ticks.inc(group=group.name)
        self._m_duration.set(round(dt_group, 6), group=group.name)
        obs_metrics.observe("filodb_rule_tick_seconds", _TICK_HELP,
                            dt_group)
        now_wall = self._clock()
        with self._lock:
            st = self._group_state.setdefault(group.name, {})
            st["last_tick"] = at_s
            st["last_tick_wall"] = now_wall
            st["last_duration_s"] = round(dt_group, 6)
            if ok:
                st["last_success_wall"] = now_wall
            self.ticks += 1
        return {"group": group.name, "at": at_s,
                "samples": written, "ok": ok,
                "duration_s": round(dt_group, 6)}

    # -- rule-plan cache --------------------------------------------------
    # topology- and schema-dependent exactly like the server's PlanCache
    # (the evaluation range is rebased out of the key): the standalone
    # server registers invalidate_plans with the plan cache's
    # add_invalidation_listener, so every event that clears parsed plans
    # clears these too
    def _plan_for(self, ds: str, expr: str, start_ms: int, step_ms: int,
                  end_ms: int):
        """Parsed plan for one rule, range-rebased onto this tick's
        grid. Parsing happens once per (dataset, expr, step); every
        subsequent tick rebases the cached plan like the server's plan
        cache does. Non-rebasable shapes (@/subquery) re-parse."""
        key = (ds, expr, step_ms)
        with self._lock:
            cached = self._plan_cache.get(key)
        if cached is not None:
            return (lp_replace_range(cached, start_ms, step_ms, end_ms),
                    "hit")
        plan = parse_query_range(
            expr, TimeStepParams(start_ms // 1000,
                                 max(1, step_ms // 1000),
                                 end_ms // 1000))
        if _cacheable(plan):
            with self._lock:
                self._plan_cache[key] = plan
            # the parse above used second-granularity params; rebase
            # onto the exact ms grid (sub-second intervals included)
            return (lp_replace_range(plan, start_ms, step_ms, end_ms),
                    "miss")
        return plan, "uncacheable"

    def invalidate_plans(self, reason: str = "") -> None:
        """Topology/schema invalidation hook — wired to the server plan
        cache's listener chain, so every publisher that clears parsed
        plans clears the rules engine's too."""
        with self._lock:
            self._plan_cache.clear()
            self.plan_invalidations += 1

    # -- result extraction -------------------------------------------------
    @staticmethod
    def _last_column(res, group: RuleGroup, rule: Rule
                     ) -> List[Tuple[Dict[str, str], float]]:
        """The tick's samples: (labels, value) per series at the LAST
        grid step, NaN (no sample / filtered-out comparison) dropped."""
        out: List[Tuple[Dict[str, str], float]] = []
        if isinstance(res, ScalarResult):
            v = float(res.values[-1])
            if math.isfinite(v):
                out.append(({}, v))
            return out
        if not isinstance(res, GridResult):
            raise ValueError(
                f"rule {rule.name!r}: unsupported result "
                f"{type(res).__name__}")
        if res.is_hist():
            raise ValueError(
                f"rule {rule.name!r}: native-histogram results cannot "
                f"be recorded; aggregate to buckets/quantiles first")
        for i, key in enumerate(res.keys):
            v = float(res.values[i, -1])
            if math.isfinite(v):
                out.append((dict(key), v))
        if group.limit and len(out) > group.limit:
            raise ValueError(
                f"rule {rule.name!r}: produced {len(out)} series, over "
                f"the group limit {group.limit}")
        return out

    def _out_labels(self, metric: str, series_labels: Dict[str, str],
                    rule: Rule, extra: Optional[Dict[str, str]] = None
                    ) -> Dict[str, str]:
        """Re-tag one output series into the reserved rules dataset:
        internal identity labels, then the source series' labels, then
        the rule's static labels (which override, Prometheus
        semantics). No worker label — a recorded series is a LOGICAL
        series whose identity must survive evaluator failover."""
        labels = {"_ws_": RULES_TENANT, "_ns_": self.node or "node",
                  "_metric_": metric}
        for k, v in series_labels.items():
            if k not in _RESERVED_LABELS:
                labels[k] = v
        for k, v in rule.labels:
            labels[k] = v
        for k, v in (extra or {}).items():
            labels[k] = v
        return labels

    def _record_samples(self, group: RuleGroup, rule: Rule,
                        col: List[Tuple[Dict, float]], end_ms: int,
                        samples: List) -> int:
        from filodb_tpu_torch.obs.writeback import schema_for_sample
        if rule.schema == "counter":
            schema = "prom-counter"
        elif rule.schema == "gauge":
            schema = "gauge"
        else:
            schema = schema_for_sample("", rule.name)
        for series_labels, value in col:
            samples.append((schema,
                            self._out_labels(rule.name, series_labels,
                                             rule),
                            end_ms, value))
        return len(col)

    # -- alert state machine ----------------------------------------------
    def _apply_alert_state(self, group: RuleGroup, rule: Rule,
                           col: List[Tuple[Dict, float]], at_s: float,
                           samples: List) -> int:
        """inactive -> pending -> firing (and back): the expression's
        surviving series are the ACTIVE set; a series held active for
        ``for:`` promotes to firing; a series that drops out resolves
        immediately. Called only on a SUCCESSFUL evaluation — an eval
        error keeps the previous state (alerts must not flap to
        inactive because the evaluator had a bad tick)."""
        rkey = (group.name, rule.name)
        fired: List[Dict] = []
        resolved: List[Dict] = []
        events: List[Dict] = []

        def note(labels: Dict, frm: str, to: str, value) -> None:
            events.append({
                "at": at_s, "group": group.name, "alert": rule.name,
                "from": frm, "to": to, "labels": dict(labels),
                "value": None if value is None else float(value)})

        with self._lock:
            insts = self._alerts.setdefault(rkey, {})
            active_now: Dict[Tuple, Tuple[Dict, float]] = {}
            for series_labels, value in col:
                ident = dict(series_labels)
                for k, v in rule.labels:
                    ident[k] = v
                ident.pop("_metric_", None)
                key = tuple(sorted(ident.items()))
                active_now[key] = (ident, value)
            for key, (ident, value) in active_now.items():
                inst = insts.get(key)
                if inst is None:
                    state = STATE_FIRING if rule.for_s <= 0 \
                        else STATE_PENDING
                    inst = {"labels": ident, "state": state,
                            "active_at": at_s, "value": value}
                    insts[key] = inst
                    note(ident, STATE_INACTIVE, state, value)
                    if state == STATE_FIRING:
                        fired.append(inst)
                else:
                    inst["value"] = value
                    if inst["state"] == STATE_PENDING \
                            and at_s - inst["active_at"] >= rule.for_s:
                        inst["state"] = STATE_FIRING
                        note(ident, STATE_PENDING, STATE_FIRING, value)
                        fired.append(inst)
            for key in [k for k in insts if k not in active_now]:
                inst = insts.pop(key)
                note(inst["labels"], inst["state"], STATE_INACTIVE,
                     inst.get("value"))
                if inst["state"] == STATE_FIRING:
                    resolved.append(inst)
            live = list(insts.values())
            self._transitions.extend(events)
        # counters + trace point events outside the lock (registry
        # family leaves are locked internally)
        for ev in events:
            self._m_transitions.inc(alertname=rule.name, to=ev["to"])
            obs_trace.event("alert-transition", alert=rule.name,
                            frm=ev["from"], to=ev["to"])
        # synthetic state series (Prometheus ALERTS/ALERTS_FOR_STATE):
        # one sample per active instance per tick
        end_ms = int(round(at_s * 1000))
        for inst in live:
            samples.append((
                "gauge",
                self._out_labels("ALERTS", inst["labels"], rule,
                                 extra={"alertname": rule.name,
                                        "alertstate": inst["state"]}),
                end_ms, 1.0))
            samples.append((
                "gauge",
                self._out_labels("ALERTS_FOR_STATE", inst["labels"],
                                 rule, extra={"alertname": rule.name}),
                end_ms, float(inst["active_at"])))
        self._update_alert_gauges(rule.name)
        if self.notifier is not None:
            for inst in fired:
                self._notify(group, rule, inst, "firing", at_s)
            for inst in resolved:
                self._notify(group, rule, inst, "resolved", at_s)
        return len(live)

    def _update_alert_gauges(self, alertname: str) -> None:
        # zeroed-by-default counts: a state an alert LEFT reads 0, not
        # its last nonzero value
        counts = {STATE_PENDING: 0, STATE_FIRING: 0}
        with self._lock:
            for (_g, rname), insts in self._alerts.items():
                if rname != alertname:
                    continue
                for inst in insts.values():
                    counts[inst["state"]] = \
                        counts.get(inst["state"], 0) + 1
        for state, n in counts.items():
            self._m_alerts.set(n, alertname=alertname, alertstate=state)

    def _notify(self, group: RuleGroup, rule: Rule, inst: Dict,
                status: str, at_s: float) -> None:
        labels = dict(inst["labels"])
        labels["alertname"] = rule.name
        ann = {k: _render_template(v, inst.get("value"), labels)
               for k, v in rule.annotations}
        self.notifier.enqueue({
            "status": status,
            "labels": labels,
            "annotations": ann,
            "value": inst.get("value"),
            "activeAt": inst.get("active_at"),
            "at": at_s,
            "group": group.name,
        })
        with self._lock:
            self.notifications_enqueued += 1

    # -- observability -----------------------------------------------------
    def _collect(self, builder) -> None:
        """Registry collector: election + per-group health gauges
        (values land on pre-created gauge families, so a reset registry
        is never repopulated by a stale engine)."""
        if self._stopped:
            return
        with self._lock:
            active = self.active
            groups = [(g.name, g.interval_s, len(g.rules),
                       self._group_state.get(g.name, {}))
                      for g in self.groups]
        self._m_active.set(1 if active else 0)
        now = self._clock()
        for name, interval_s, n_rules, st in groups:
            self._m_interval.set(interval_s, group=name)
            self._m_rules.set(n_rules, group=name)
            last_ok = st.get("last_success_wall")
            if last_ok is not None:
                self._m_staleness.set(round(max(0.0, now - last_ok), 3),
                                      group=name)

    # -- API payloads ------------------------------------------------------
    def rules_payload(self, explain: bool = False) -> Dict:
        """The ``/api/v1/rules`` data section (Prometheus shape, plus
        the engine's election/provenance fields; ``explain`` adds the
        retained last-evaluation detail per rule)."""
        groups_out = []
        with self._lock:
            rule_state = {k: dict(v) for k, v in self._rule_state.items()}
            alerts = {k: [dict(i) for i in v.values()]
                      for k, v in self._alerts.items()}
            group_state = {k: dict(v)
                           for k, v in self._group_state.items()}
            active = self.active
        for g in self.groups:
            st = group_state.get(g.name, {})
            rules_out = []
            for r in g.rules:
                rs = rule_state.get((g.name, r.name), {})
                le = rs.get("last_eval") or {}
                entry = {
                    "type": "alerting" if r.is_alert else "recording",
                    "name": r.name,
                    "query": r.expr,
                    "labels": dict(r.labels),
                    "health": rs.get("health", "unknown"),
                    "lastError": rs.get("last_error") or "",
                    "lastEvaluation": le.get("at"),
                    "evaluationTime": le.get("duration_s"),
                }
                if r.is_alert:
                    entry["duration"] = r.for_s
                    entry["annotations"] = dict(r.annotations)
                    insts = alerts.get((g.name, r.name), [])
                    entry["alerts"] = [self._alert_json(r, i)
                                       for i in insts]
                    entry["state"] = self._rule_alert_state(insts)
                if explain:
                    entry["lastEval"] = le
                rules_out.append(entry)
            groups_out.append({
                "name": g.name,
                "interval": g.interval_s,
                "dataset": g.dataset or self.default_dataset,
                "lastEvaluation": st.get("last_tick"),
                "evaluationTime": st.get("last_duration_s"),
                "rules": rules_out,
            })
        return {"groups": groups_out, "evaluating": active,
                "evaluator": self.evaluator_ordinal(),
                "worker": self.worker_id, "node": self.node}

    @staticmethod
    def _rule_alert_state(insts: List[Dict]) -> str:
        if any(i["state"] == STATE_FIRING for i in insts):
            return STATE_FIRING
        if insts:
            return STATE_PENDING
        return STATE_INACTIVE

    def _alert_json(self, rule: Rule, inst: Dict) -> Dict:
        labels = dict(inst["labels"])
        labels["alertname"] = rule.name
        return {
            "labels": labels,
            "annotations": {
                k: _render_template(v, inst.get("value"), labels)
                for k, v in rule.annotations},
            "state": inst["state"],
            "activeAt": inst.get("active_at"),
            "value": inst.get("value"),
        }

    def alerts_payload(self) -> Dict:
        """The ``/api/v1/alerts`` data section + the structured
        transition-event ring."""
        out = []
        with self._lock:
            items = [(rname, [dict(i) for i in insts.values()])
                     for (_g, rname), insts in self._alerts.items()]
            transitions = list(self._transitions)
        by_name = {r.name: r for g in self.groups for r in g.rules}
        for rname, insts in items:
            rule = by_name.get(rname)
            if rule is None:
                continue
            out.extend(self._alert_json(rule, i) for i in insts)
        return {"alerts": out, "transitions": transitions}

    def snapshot(self) -> Dict:
        with self._lock:
            return {"active": self.active,
                    "announced": self._announced,
                    "ordinal": self._ordinal,
                    "alive_ordinals": sorted(self._alive),
                    "groups": len(self.groups),
                    "ticks": self.ticks,
                    "errors": self.errors,
                    "plan_invalidations": self.plan_invalidations,
                    "notifications_enqueued":
                        self.notifications_enqueued,
                    "election_log": list(self._election_log),
                    "alive": self.alive}
