"""Nexmark query pipelines.

Port of ``risingwave_tpu/queries/nexmark_q.py:38-84`` (q5-lite).
Reference queries: e2e_test/nexmark/ — q5 (hot items) counts bids per
auction per hop window (size 10 s, slide 2 s); "q5-lite" is its
stateful core, the HashAgg stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from risingwave_tpu_torch import resolve_device
from risingwave_tpu_torch.executors.hash_agg import HashAggExecutor
from risingwave_tpu_torch.executors.hop_window import HopWindowExecutor
from risingwave_tpu_torch.executors.materialize import DeviceMaterializeExecutor
from risingwave_tpu_torch.ops.agg import AggCall
from risingwave_tpu_torch.runtime.pipeline import Pipeline

Q5_WINDOW_MS = 10_000
Q5_SLIDE_MS = 2_000


@dataclass
class Q5Lite:
    pipeline: Pipeline
    agg: HashAggExecutor
    mview: DeviceMaterializeExecutor


def build_q5_lite(
    capacity: int = 1 << 16,
    window_ms: int = Q5_WINDOW_MS,
    slide_ms: int = Q5_SLIDE_MS,
    state_cleaning: bool = True,
    device="cuda",
) -> Q5Lite:
    """bids -> hop window -> COUNT(*) per (auction, window_start) -> MV.

    ``state_cleaning`` declares the agg's window key as the reference
    does; watermark state cleaning is not ported yet, so a
    ``window_start`` watermark then raises NotImplementedError. Run
    with ``state_cleaning=False``.
    """
    dev = resolve_device(device)
    hop = HopWindowExecutor("date_time", window_ms, slide_ms)
    agg = HashAggExecutor(
        group_keys=("auction", "window_start"),
        calls=(AggCall("count_star", None, "num"),),
        schema_dtypes={"auction": torch.int64, "window_start": torch.int64},
        capacity=capacity,
        table_id="q5.agg",
        window_key=("window_start", 0, False) if state_cleaning else None,
        device=dev,
    )
    mview = DeviceMaterializeExecutor(
        pk=("auction", "window_start"),
        columns=("num",),
        schema_dtypes={
            "auction": torch.int64,
            "window_start": torch.int64,
            "num": torch.int64,
        },
        table_id="q5.mview",
        capacity=max(1 << 12, capacity),
        device=dev,
    )
    return Q5Lite(Pipeline([hop, agg, mview]), agg, mview)
