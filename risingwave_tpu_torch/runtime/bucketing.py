"""Capacity planning for the padded state tables.

Port of the part of ``risingwave_tpu/runtime/bucketing.py`` (:74-127,
:160-416) that the HashAgg, device-MV, dedup, join and TopN
``_maybe_grow`` and the fused programs' flush rounds and growth hints
use: tables walk a power-of-two lattice, grow eagerly past the load
factor and shrink lazily after ``patience`` quiet barriers, so a window
churning at a bucket boundary grows once and stays. The host-diff
executors (plain and retractable TopN) pad their emissions to a pow2
bucket (``emission_bucket``). The governor pin/veto hooks and the
environment overrides are not ported; no executor of the port has the
reference's unbucketed twin, so ``needs_plan`` and ``plan_capacity``
(:417, :432) reduce to the allocator's ``should_plan`` and ``plan``,
which the executors call directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# lattice span above the configured capacity (8 doublings = 256x)
DEFAULT_MAX_STEPS = 8
# no lattice exceeds 2^26 slots
ABS_MAX_CAP = 1 << 26


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def lattice_between(lo: int, hi: int) -> Tuple[int, ...]:
    """All pow2 capacities in [lo, hi] (lo/hi rounded up to pow2)."""
    lo = pow2_at_least(lo)
    hi = max(pow2_at_least(hi), lo)
    out = []
    c = lo
    while c <= hi:
        out.append(c)
        c <<= 1
    return tuple(out)


def emission_bucket(n: int, floor: int = 2) -> int:
    """Pow2 emission capacity for an n-row host-built delta chunk, so
    downstream programs see at most log2(max delta) distinct shapes."""
    return pow2_at_least(max(int(n), floor))


def flush_pad(out_cap: int, emitted_bound: int) -> int:
    """The agg-flush emission lattice: a delta chunk's capacity is one
    of exactly two buckets (small | full), from a bound on its rows."""
    full = 2 * int(out_cap)
    small = min(256, full)
    return small if 2 * int(emitted_bound) <= small else full


def flush_pad_schedule(dirty_bound: int, capacity: int, out_cap: int) -> Tuple[int, ...]:
    """Per-round flush pads for one barrier, from the host dirty bound
    (no device read): round r drains up to ``out_cap`` dirty groups, so
    its emitted-rows bound is what remains of the clamped bound. At
    least one round; a trailing over-estimate emits an all-invalid
    chunk, a no-op downstream."""
    bound = min(int(dirty_bound), int(capacity))
    rounds = max(1, -(-bound // out_cap))
    return tuple(
        flush_pad(out_cap, min(max(bound - r * out_cap, 0), out_cap))
        for r in range(rounds)
    )


@dataclass(frozen=True)
class BucketPolicy:
    """Hysteresis of one table's bucket walk: eager growth past
    ``grow_at``; shrink only after occupancy stayed below
    ``shrink_at * capacity`` for ``patience`` barriers."""

    min_cap: int
    max_cap: int
    grow_at: float = 0.5
    shrink_at: float = 0.125
    patience: int = 4

    def __post_init__(self):
        if self.min_cap & (self.min_cap - 1) or self.min_cap <= 0:
            raise ValueError(f"min_cap {self.min_cap} not a power of two")
        if self.max_cap < self.min_cap:
            raise ValueError("max_cap < min_cap")
        if not (0.0 < self.shrink_at < self.grow_at <= 1.0):
            raise ValueError("need 0 < shrink_at < grow_at <= 1 for hysteresis")

    @staticmethod
    def from_capacity(capacity: int, grow_at: float = 0.5) -> "BucketPolicy":
        """Lattice from the configured capacity up to 2^8 times it."""
        lo = min(pow2_at_least(capacity), ABS_MAX_CAP)
        hi = min(lo << DEFAULT_MAX_STEPS, ABS_MAX_CAP)
        return BucketPolicy(min_cap=lo, max_cap=max(hi, lo), grow_at=grow_at)

    def lattice(self) -> Tuple[int, ...]:
        return lattice_between(self.min_cap, self.max_cap)


class BucketAllocator:
    """Capacity planner for one table: ``plan`` picks the next capacity
    (or None), ``note_barrier`` feeds the lazy-shrink streak."""

    def __init__(self, policy: BucketPolicy):
        self.policy = policy
        self._streak = 0
        self._pending_shrink: Optional[int] = None
        # demand exceeds the lattice max and a same-cap rebuild cannot
        # relieve it: the apply-path trigger stays off until the next
        # barrier re-checks (reference :246-252)
        self._saturated = False

    def should_plan(self, cap: int, bound: int, incoming: int) -> bool:
        """The apply path's cheap pre-check: past the load factor, or a
        pending shrink to apply."""
        if not self._saturated and bound + incoming > cap * self.policy.grow_at:
            return True
        return self._pending_shrink is not None and self._pending_shrink < cap

    @property
    def lattice(self) -> Tuple[int, ...]:
        return self.policy.lattice()

    def plan(
        self,
        cap: int,
        incoming: int,
        claimed: int,
        survivors: int,
        margin: int = 0,
    ) -> Optional[int]:
        """Next capacity, or None (the current bucket still fits). A
        value equal to ``cap`` is a pure tombstone compaction. ``margin``
        adds headroom to the sizing only, never to the trigger."""
        p = self.policy
        if claimed + incoming > cap * p.grow_at:
            need = cap
            while survivors + incoming + margin > need * p.grow_at:
                need <<= 1
            new_cap = min(max(need, p.min_cap), max(p.max_cap, cap))
            self._pending_shrink = None
            self._streak = 0
            if new_cap == cap and survivors + incoming > cap * p.grow_at:
                # saturated at the lattice max: a same-size rebuild does
                # not help; the overflow latch reports a real overflow
                self._saturated = True
                return None
            return new_cap
        t = self._pending_shrink
        if t is not None:
            self._pending_shrink = None
            self._streak = 0
            while survivors + incoming + margin > t * p.grow_at:
                t <<= 1
            if t < cap:
                return t
        return None

    def bump(self, cap: int) -> Optional[int]:
        """One-bucket emergency growth for a mid-epoch overflow guard
        whose host bound counts padded chunk capacities (sizing from it
        would over-grow): double once, clamped at the lattice max."""
        p = self.policy
        if cap >= p.max_cap:
            return None
        self._pending_shrink = None
        self._streak = 0
        return min(cap << 1, p.max_cap)

    def note_barrier(self, cap: int, claimed: int) -> None:
        p = self.policy
        self._saturated = False
        if cap <= p.min_cap or claimed > cap * p.shrink_at:
            self._streak = 0
            self._pending_shrink = None
            return
        self._streak += 1
        if self._streak >= p.patience:
            target = pow2_at_least(max(p.min_cap, int(claimed / p.grow_at) + 1))
            if target < cap:
                self._pending_shrink = target

