"""Webhook alert notifier: retry/backoff/breaker on the delivery path (the
counterpart of ``filodb_tpu.rules.notify``).

Alert transitions (``firing`` / ``resolved``) enqueue onto a bounded
queue drained by a dedicated notifier thread — delivery latency and
receiver outages must never stall the rule scheduler's tick loop. Each
delivery runs under the full :func:`~filodb_tpu_torch.parallel.resilience.
resilient_call` policy stack: bounded retries with exponential backoff
+ jitter on transport failure (connection refused, 5xx), and a
per-receiver circuit breaker so a dead webhook endpoint stops being
dialed entirely until its reset probe succeeds.

The payload is Alertmanager-webhook-shaped (``version``, ``status``,
``alerts: [{labels, annotations, ...}]``) so a real Alertmanager or any
generic webhook consumer can sit on the other end.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from typing import Dict, Optional

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.parallel.resilience import (BreakerRegistry, RetryPolicy,
                                                  TransportError,
                                                  resilient_call)


@guarded_by("_lock", "delivered", "failed", "dropped")
class WebhookNotifier:
    """One receiver URL, one delivery thread, one breaker."""

    def __init__(self, url: str,
                 retry: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 timeout_s: float = 5.0,
                 queue_size: int = 256):
        self.url = str(url)
        self.timeout_s = float(timeout_s)
        self.retry = retry or RetryPolicy(max_attempts=3,
                                          base_delay_s=0.1)
        # a private registry by default: webhook-receiver breaker state
        # must not open/close the QUERY plane's per-peer breakers
        self.breakers = breakers or BreakerRegistry(
            failure_threshold=3, reset_timeout_s=5.0)
        self._q: "queue.Queue[Dict]" = queue.Queue(maxsize=queue_size)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.delivered = 0
        self.failed = 0
        self.dropped = 0
        reg = obs_metrics.GLOBAL_REGISTRY
        self._m_sent = reg.counter(
            "filodb_rule_notifications_total",
            "Webhook alert notifications, by delivery outcome")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "WebhookNotifier":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rules-notifier")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- producer side (the rule scheduler) --------------------------------
    def enqueue(self, notification: Dict) -> bool:
        """Non-blocking enqueue; a full queue DROPS (counted) rather
        than stalling the scheduler tick."""
        try:
            self._q.put_nowait(notification)
            return True
        except queue.Full:
            with self._lock:
                self.dropped += 1
            self._m_sent.inc(outcome="dropped")
            return False

    # -- delivery ----------------------------------------------------------
    @thread_root("rules-notifier")
    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                notification = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self.deliver(notification)
                with self._lock:
                    self.delivered += 1
                self._m_sent.inc(outcome="delivered")
            except Exception:   # noqa: BLE001 — a dead receiver must not
                with self._lock:        # kill the notifier loop
                    self.failed += 1
                self._m_sent.inc(outcome="failed")

    def deliver(self, notification: Dict) -> None:
        """One delivery under the resilience stack (public for tests).
        Raises on exhausted retries / open breaker."""
        body = json.dumps({
            "version": "4",
            "status": notification.get("status", "firing"),
            "receiver": "filodb-rules",
            "alerts": [{
                "status": notification.get("status", "firing"),
                "labels": notification.get("labels") or {},
                "annotations": notification.get("annotations") or {},
                "value": notification.get("value"),
                "activeAt": notification.get("activeAt"),
            }],
        }).encode()

        def do_call(timeout_s: float):
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req,
                                            timeout=timeout_s) as r:
                    if r.status >= 500:
                        raise TransportError(
                            f"webhook {self.url} answered {r.status}")
                    return r.status
            except OSError as e:
                # urllib surfaces 5xx as HTTPError (an OSError): the
                # receiver is broken, not the request — retryable
                code = getattr(e, "code", None)
                if code is not None and code < 500:
                    raise   # 4xx: our payload's fault; retrying repeats it
                raise TransportError(
                    f"webhook {self.url} unreachable: {e}") from e

        resilient_call(do_call, key=self.url, node_id="webhook",
                       timeout_s=self.timeout_s, retry=self.retry,
                       breakers=self.breakers)

    def snapshot(self) -> Dict:
        with self._lock:
            out = {"delivered": self.delivered, "failed": self.failed,
                   "dropped": self.dropped, "queued": self._q.qsize(),
                   "alive": self.alive}
        out["breaker"] = self.breakers.get(self.url).state
        return out
