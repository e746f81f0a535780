"""Deadline-aware admission control + adaptive pipeline depth.

Past the saturation knee an open-loop arrival process grows the submit
queue without bound: every request eventually retires, but all of them
late — goodput (deadline-met throughput) collapses to zero while raw
throughput stays pinned at capacity (the loadgen measurements).
DisaggRec's sizing argument (PAPERS.md) and the ROADMAP's first open item
both call for the opposite response: *shed early, serve the rest on time*.

:class:`AdmissionController` implements that response at the submit
boundary of ``runtime.serving.FlexEMRServer``:

  * **Bounded queue** — more than ``max_queue`` requests waiting for a
    batch slot is a fast-fail (``queue_full``), not an unbounded deque.
  * **Deadline estimate** — an EMA over observed batch-retire intervals
    and batch sizes prices the time a request admitted *now* will wait:
    the batches ahead of it (queued requests / EMA batch size, plus the
    pipeline occupancy, plus its own batch) times the EMA seconds per
    batch, times ``headroom``.  A request whose remaining deadline budget
    cannot cover that estimate is shed at submit (``deadline``) instead
    of wasting a pipeline slot to miss its SLO anyway.
  * **Already-expired fast-fail** — a request arriving with its deadline
    spent sheds unconditionally (``expired``), even before the estimator
    has warmed up.
  * **Adaptive pipeline depth** — under a sustained burn-rate alert
    (``obs.slo.SloMonitor.alerting``) the effective pipeline depth
    shrinks one step per retired batch toward ``min_depth``: a shorter
    pipeline holds less latent work, so queue_wait stops compounding
    across stages.  After ``regrow_after`` consecutive calm retires it
    re-grows one step toward the configured depth.

The controller is driven entirely by the serving thread (submit + retire
both run there), so it keeps plain counters; the ``serve.admission.*``
metrics namespace is its :meth:`summary`.

Shedding never touches accepted work: admitted requests flow the exact
same path as with admission off, so their outputs are bit-equal to an
unthrottled run — the overload bench gates on precisely that.
"""
from __future__ import annotations


class ShedError(RuntimeError):
    """A request rejected at submit (overload shed) — typed so callers can
    fast-fail cheaply and count the reason.

    ``reason`` is one of ``"expired"`` (deadline already spent at submit),
    ``"queue_full"`` (bounded submit queue at capacity), or ``"deadline"``
    (the admission estimate says the deadline cannot be met).
    """

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class AdmissionController:
    """Deadline admission + adaptive depth (see module docstring)."""

    def __init__(
        self,
        max_queue: int = 256,
        headroom: float = 1.2,
        ema_alpha: float = 0.2,
        min_samples: int = 8,
        min_depth: int = 1,
        regrow_after: int = 8,
    ):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if headroom < 1.0:
            raise ValueError("headroom must be >= 1.0")
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        if regrow_after < 1:
            raise ValueError("regrow_after must be >= 1")
        self.max_queue = max_queue
        self.headroom = headroom
        self.ema_alpha = ema_alpha
        self.min_samples = min_samples
        self.min_depth = min_depth
        self.regrow_after = regrow_after
        # Live service-time model (EMAs over retired batches).
        self._interval_ema: float | None = None  # seconds per retired batch
        self._batch_ema: float | None = None  # requests per retired batch
        self._last_retire: float | None = None
        self._samples = 0
        # Adaptive depth state (attach() pins the configured maximum).
        self.max_depth = 1
        self.depth = 1
        self._calm_retires = 0
        # Counters (the serve.admission.* namespace).
        self.admitted = 0
        self.shed_expired = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.depth_shrinks = 0
        self.depth_regrows = 0

    # ------------------------------------------------------------- lifecycle

    def attach(self, pipeline_depth: int) -> None:
        """Bind to a server: the configured depth is the regrow ceiling."""
        self.max_depth = max(self.min_depth, int(pipeline_depth))
        self.depth = self.max_depth

    # ------------------------------------------------------------- estimates

    def estimate_retire_s(self, queued: int, occupancy: int) -> float | None:
        """Priced wait for a request admitted now: the batches ahead of it
        (queued work re-batched at the EMA batch size, plus the occupied
        pipeline slots) plus its own batch, at the EMA seconds per batch,
        padded by ``headroom``.  None until the model has warmed up."""
        if self._samples < self.min_samples:
            return None
        batches_ahead = queued / max(self._batch_ema, 1.0) + occupancy + 1.0
        return batches_ahead * self._interval_ema * self.headroom

    # -------------------------------------------------------------- decisions

    def check(
        self,
        now: float,
        arrival: float,
        deadline_s: float | None,
        queued: int,
        occupancy: int,
    ) -> None:
        """Admit or shed one submit.  Raises :class:`ShedError` to shed;
        returns silently (and counts the admit) to accept."""
        elapsed = now - arrival
        if deadline_s is not None and elapsed >= deadline_s:
            self.shed_expired += 1
            raise ShedError(
                f"deadline expired at submit ({elapsed * 1e3:.1f}ms elapsed"
                f" >= {deadline_s * 1e3:.1f}ms budget)",
                reason="expired",
            )
        if queued >= self.max_queue:
            self.shed_queue_full += 1
            raise ShedError(
                f"submit queue full ({queued} >= {self.max_queue})",
                reason="queue_full",
            )
        if deadline_s is not None:
            est = self.estimate_retire_s(queued, occupancy)
            if est is not None and elapsed + est > deadline_s:
                self.shed_deadline += 1
                raise ShedError(
                    f"deadline unmeetable: {est * 1e3:.1f}ms estimated"
                    f" retire vs {(deadline_s - elapsed) * 1e3:.1f}ms"
                    " remaining budget",
                    reason="deadline",
                )
        self.admitted += 1

    def on_retire(self, now: float, batch_size: int, alerting: bool) -> int:
        """Feed one retired batch into the service-time model and step the
        adaptive depth.  Returns the depth delta (-1, 0, +1)."""
        a = self.ema_alpha
        if self._last_retire is not None:
            interval = now - self._last_retire
            if self._interval_ema is None:
                self._interval_ema = interval
            else:
                # Clamp a pathological gap (a stall, a chaos watchdog) so
                # one outlier cannot poison the estimate for many batches.
                interval = min(interval, 5.0 * self._interval_ema)
                self._interval_ema += a * (interval - self._interval_ema)
            self._samples += 1
        self._last_retire = now
        if self._batch_ema is None:
            self._batch_ema = float(batch_size)
        else:
            self._batch_ema += a * (batch_size - self._batch_ema)
        # Adaptive depth: shrink under a sustained alert, regrow on calm.
        if alerting:
            self._calm_retires = 0
            if self.depth > self.min_depth:
                self.depth -= 1
                self.depth_shrinks += 1
                return -1
        else:
            self._calm_retires += 1
            if (
                self._calm_retires >= self.regrow_after
                and self.depth < self.max_depth
            ):
                self._calm_retires = 0
                self.depth += 1
                self.depth_regrows += 1
                return +1
        return 0

    # ---------------------------------------------------------------- metrics

    @property
    def shed(self) -> int:
        return self.shed_expired + self.shed_queue_full + self.shed_deadline

    def summary(self) -> dict:
        """The ``serve.admission.*`` namespace."""
        total = self.admitted + self.shed
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "shed_expired": self.shed_expired,
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "shed_frac": self.shed / total if total else 0.0,
            "depth": self.depth,
            "max_depth": self.max_depth,
            "depth_shrinks": self.depth_shrinks,
            "depth_regrows": self.depth_regrows,
            "est_interval_s": self._interval_ema or 0.0,
            "est_batch_size": self._batch_ema or 0.0,
            "max_queue": self.max_queue,
        }
