"""Transient-fault resilience kernel — retry, breaker.

Port of ``risingwave_tpu/resilience.py`` (:60-408), host only: the
names the checkpoint layer imports. ``DeltaSpill`` (degraded-mode
staging) is not ported.

Reference: every object-store touch in the reference goes through a
retrying, monitored wrapper (src/object_store/src/object/mod.rs —
``RetryCondition`` + backoff around each op, per-op timeouts from
``ObjectStoreConfig``), and the madsim tier injects faults to assert
the cluster converges anyway. This module is that boundary for the
whole engine:

- ``RetryPolicy``: exponential backoff with deterministic seeded
  jitter, a per-attempt timeout hint, an overall deadline, and a
  transient-vs-fatal error classifier. Every retry loop built on it is
  provably bounded: attempts <= max_attempts AND sleep never crosses
  the deadline.
- ``CircuitBreaker``: closed -> open -> half-open with cooldown, so a
  hard-down dependency fails fast instead of eating a full retry
  budget per op; transitions land in the event log and metrics.
- ``RetryingObjectStore``: the durability-boundary wrapper used by
  ``CheckpointManager`` for SST upload / manifest commit / compaction
  IO. Ops are idempotent (immutable blobs; manifest put overwrites),
  so blind retry is safe.

Classification contract: ``TransientStoreError`` subclasses OSError so
the storage layer's existing read-race handling treats injected faults
exactly like a GC race. ``CrashPoint`` (sim/chaos.py) is a
BaseException and always propagates — a retry loop must never "handle"
a process death.

Env knobs (also exposed via ``config.ResilienceConfig``):
  RW_RETRY_MAX_ATTEMPTS     (default 8)
  RW_RETRY_BASE_BACKOFF_MS  (default 50)
  RW_RETRY_MAX_BACKOFF_MS   (default 2000)
  RW_RETRY_DEADLINE_S       (default 30)
  RW_RETRY_JITTER           (default 0.5, fraction of the backoff)
  RW_BREAKER_THRESHOLD      (default 5 consecutive failures)
  RW_BREAKER_COOLDOWN_S     (default 5)
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from risingwave_tpu_torch.metrics import REGISTRY

# NOTE: this module is the resilience KERNEL — it must not import the
# storage package (state_table imports us; the object-store protocol is
# duck-typed here, exactly like every store wrapper in sim/chaos.py).


class TransientStoreError(OSError):
    """A fault the caller should retry: flaky blob store, slow upload,
    connection blip. OSError subclass on purpose — the storage read
    paths already treat OSError as a transient race."""


#: error types retried by default. FileNotFoundError/PermissionError
#: are OSErrors but SEMANTIC (a miss / a config error), never retried
#: unless a caller's classifier says otherwise (storage reads do:
#: there, a missing SST is a compaction-GC race).
DEFAULT_TRANSIENT = (
    TransientStoreError,
    ConnectionError,
    TimeoutError,
    InterruptedError,
)
DEFAULT_FATAL = (FileNotFoundError, PermissionError, IsADirectoryError)


def default_classify(exc: Exception) -> bool:
    return isinstance(exc, DEFAULT_TRANSIENT) and not isinstance(
        exc, DEFAULT_FATAL
    )


def _env_val(name: str, cast, default):
    """One env knob: ``cast(os.environ[name])``, falling back to
    ``default`` when unset or unparseable."""
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return cast(v)
    except ValueError:
        return default


class RetryBudgetExceeded(RuntimeError):
    """The retry loop's budget (attempts or deadline) ran out. Carries
    the schedule so operators can see WHY it gave up."""

    def __init__(self, op: str, attempts: int, elapsed_s: float,
                 last_error: Optional[BaseException]):
        self.op = op
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_error = last_error
        super().__init__(
            f"retry budget exceeded for {op!r}: {attempts} attempts over "
            f"{elapsed_s:.3f}s (last: {last_error!r})"
        )


class CircuitOpenError(RuntimeError):
    """Fast-fail: the breaker is open; the dependency is presumed down
    until the cooldown elapses and a half-open probe succeeds."""


@dataclass
class RetryPolicy:
    """Bounded retry: exponential backoff, seeded jitter, deadline.

    ``per_attempt_timeout_s`` is a HINT for callers whose ops accept a
    timeout (socket settimeout, ranged GETs); pure-python attempts
    cannot be preempted, but an overrunning attempt still counts
    against the overall deadline, so the loop stays bounded."""

    max_attempts: int = 8
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    deadline_s: float = 30.0
    per_attempt_timeout_s: Optional[float] = None
    jitter_frac: float = 0.5
    seed: int = 0
    classify: Callable[[Exception], bool] = field(default=default_classify)

    @classmethod
    def from_env(cls, **defaults) -> "RetryPolicy":
        """Policy from the ``RW_RETRY_*`` knobs. ``defaults`` supply
        the caller's baseline for unset knobs (and pass through fields
        with no env backing, e.g. ``classify``) — a SET env var always
        wins, so the operator's no-restart escape hatch works even for
        callers that pin their own defaults."""
        kw = dict(
            max_attempts=_env_val(
                "RW_RETRY_MAX_ATTEMPTS", int,
                defaults.pop("max_attempts", 8),
            ),
            base_backoff_s=_env_val(
                "RW_RETRY_BASE_BACKOFF_MS",
                lambda v: float(v) / 1e3,
                defaults.pop("base_backoff_s", 0.05),
            ),
            max_backoff_s=_env_val(
                "RW_RETRY_MAX_BACKOFF_MS",
                lambda v: float(v) / 1e3,
                defaults.pop("max_backoff_s", 2.0),
            ),
            deadline_s=_env_val(
                "RW_RETRY_DEADLINE_S", float,
                defaults.pop("deadline_s", 30.0),
            ),
            jitter_frac=_env_val(
                "RW_RETRY_JITTER", float,
                defaults.pop("jitter_frac", 0.5),
            ),
        )
        kw.update(defaults)
        return cls(**kw)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Deterministic backoff for the ``attempt``-th retry (1-based):
        exp growth capped at max, minus a seeded jitter slice (jitter
        shrinks the wait — the cap stays a provable bound)."""
        b = min(
            self.max_backoff_s,
            self.base_backoff_s * (self.multiplier ** (attempt - 1)),
        )
        return b * (1.0 - self.jitter_frac * rng.random())

    def run(
        self,
        fn: Callable[[], object],
        op: str = "op",
        classify: Optional[Callable[[Exception], bool]] = None,
        on_retry: Optional[Callable[[Exception, int], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        """Run ``fn`` with retries. Transient errors (per ``classify``)
        are retried with backoff until success, ``max_attempts``, or
        ``deadline_s`` — whichever comes first. Fatal errors and
        BaseExceptions (CrashPoint!) propagate immediately. ``on_retry``
        fires before each backoff sleep (breaker hookup, manifest
        reload)."""
        classify = classify or self.classify
        rng: Optional[random.Random] = None  # built on first failure:
        t0 = clock()  # the success path stays allocation-light
        last: Optional[Exception] = None
        # "no retries" (max_attempts<=1, incl. a 0 from the env knob)
        # still means ONE attempt — fn always runs at least once
        for attempt in range(1, max(1, self.max_attempts) + 1):
            try:
                out = fn()
                if attempt > 1:
                    REGISTRY.counter(
                        "retry_success_after_retry_total"
                    ).inc(op=op)
                return out
            except Exception as e:
                if not classify(e):
                    raise
                if rng is None:
                    rng = random.Random(self.seed)
                last = e
                REGISTRY.counter("retries_total").inc(op=op)
                if on_retry is not None:
                    on_retry(e, attempt)
                elapsed = clock() - t0
                wait = self.backoff_s(attempt, rng)
                if (
                    attempt >= max(1, self.max_attempts)
                    or elapsed + wait >= self.deadline_s
                ):
                    break
                sleep(wait)
        REGISTRY.counter("retry_giveups_total").inc(op=op)
        raise RetryBudgetExceeded(
            op, attempt, clock() - t0, last
        ) from last


class CircuitBreaker:
    """closed -> open -> half-open with cooldown.

    ``allow()`` gates calls: closed always passes; open fails fast
    until ``cooldown_s`` elapsed, then flips to half-open and lets
    probes through; a half-open success closes, a half-open failure
    re-opens. Transitions are recorded in the event log and as
    ``breaker_state`` / ``breaker_transitions_total`` metrics."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _STATE_NUM = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def __init__(
        self,
        name: str = "default",
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self.transitions: List[Tuple[str, str]] = []

    @classmethod
    def from_env(cls, name: str = "default", **defaults) -> "CircuitBreaker":
        """Breaker from the ``RW_BREAKER_*`` knobs; ``defaults`` are
        the caller's baseline for unset knobs (a SET env var wins)."""
        kw = dict(
            failure_threshold=_env_val(
                "RW_BREAKER_THRESHOLD", int,
                defaults.pop("failure_threshold", 5),
            ),
            cooldown_s=_env_val(
                "RW_BREAKER_COOLDOWN_S", float,
                defaults.pop("cooldown_s", 5.0),
            ),
        )
        kw.update(defaults)
        return cls(name, **kw)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # callers hold self._lock
        frm, self._state = self._state, to
        if frm == to:
            return
        self.transitions.append((frm, to))
        REGISTRY.counter("breaker_transitions_total").inc(
            name=self.name, to=to
        )
        REGISTRY.gauge("breaker_state").set(
            self._STATE_NUM[to], name=self.name
        )
        # imported here: event_log -> metrics, and this module is
        # imported by storage — keep the import graph acyclic
        from risingwave_tpu_torch.event_log import EVENT_LOG

        EVENT_LOG.record("breaker", name=self.name, frm=frm, to=to)

    def allow(self) -> bool:
        """May a call proceed right now? (Non-consuming: half-open lets
        probes through and relies on record_success/failure to settle.)"""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._transition(self.HALF_OPEN)
                    return True
                return False
            return True  # half-open: probe away

    def force_probe(self) -> None:
        """Operator/driver override: an EXPLICIT recovery is a manual
        probe — skip the cooldown and let the next call through (it
        settles the breaker via record_success/failure as usual)."""
        with self._lock:
            if self._state == self.OPEN:
                self._transition(self.HALF_OPEN)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == self.HALF_OPEN or (
                self._state == self.CLOSED
                and self._consecutive >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(self.OPEN)
            elif self._state == self.OPEN:
                # a failure while open (late probe) restarts cooldown
                self._opened_at = self._clock()


#: what the runtime treats as "the store is unavailable": degrade, do
#: not die. (RetryBudgetExceeded from a store op, or a fast-fail from
#: an open breaker.)
STORE_UNAVAILABLE = (CircuitOpenError, RetryBudgetExceeded)


class RetryingObjectStore:
    """The durability-boundary wrapper: every op retried per policy,
    gated by an optional shared breaker, counted in metrics. Safe to
    wrap ANY store: ops are idempotent (immutable blobs; manifest put
    overwrites; delete of a deleted path is a no-op). Duck-typed over
    the ObjectStore protocol so the resilience kernel stays free of
    storage imports."""

    def __init__(
        self,
        inner,
        policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.inner = inner
        self.policy = policy or RetryPolicy.from_env()
        self.breaker = breaker

    def _call(self, op: str, fn: Callable[[], object]):
        br = self.breaker
        if br is not None and not br.allow():
            REGISTRY.counter("store_fast_fails_total").inc(op=op)
            raise CircuitOpenError(
                f"object store breaker {br.name!r} is open ({op})"
            )

        def _on_retry(exc, attempt):
            # fires on EVERY transient failure (including the last):
            # the breaker sees each attempt, so a fault storm opens it
            # mid-retry-loop; fatal (semantic) errors bypass on_retry
            # and never poison the breaker
            if br is not None:
                br.record_failure()

        out = self.policy.run(fn, op=f"store.{op}", on_retry=_on_retry)
        if br is not None:
            br.record_success()
        return out

    def put(self, path: str, data: bytes) -> None:
        self._call("put", lambda: self.inner.put(path, data))

    def read(self, path: str) -> bytes:
        return self._call("read", lambda: self.inner.read(path))

    def read_range(self, path: str, off: int, length: int) -> bytes:
        return self._call(
            "read_range", lambda: self.inner.read_range(path, off, length)
        )

    def exists(self, path: str) -> bool:
        return self._call("exists", lambda: self.inner.exists(path))

    def list(self, prefix: str):
        return self._call("list", lambda: self.inner.list(prefix))

    def delete(self, path: str) -> None:
        self._call("delete", lambda: self.inner.delete(path))
