"""Runtime — epoch loop, pipelines, barriers, the actor graph.

Port of ``risingwave_tpu/runtime/__init__.py``: the exports whose
modules are ported, and the fragmenter's two ways to run a plan
(``graph_planned_mv`` over parallel actors, ``sharded_planned_mv`` over
a mesh of stacked shards). The streaming runtime, DML, source,
notification and arrangement managers come with a later slice.
"""

from risingwave_tpu_torch.runtime.pipeline import Pipeline, TwoInputPipeline

__all__ = [
    "FusedChainExecutor",
    "Pipeline",
    "TwoInputPipeline",
    "fuse_chain",
    "fuse_pipeline",
    "graph_planned_mv",
    "sharded_planned_mv",
]

# Lazy (PEP 562) exports: the fused per-barrier step imports the
# executors package (it composes their pure steps), which imports
# runtime.bucketing, so an eager import here would close a cycle
# through a partially initialized executors package.
_LAZY = {
    "FusedChainExecutor": ("risingwave_tpu_torch.runtime.fused_step", "FusedChainExecutor"),
    "fuse_chain": ("risingwave_tpu_torch.runtime.fused_step", "fuse_chain"),
    "fuse_pipeline": ("risingwave_tpu_torch.runtime.fused_step", "fuse_pipeline"),
    "graph_planned_mv": ("risingwave_tpu_torch.runtime.fragmenter", "graph_planned_mv"),
    "sharded_planned_mv": ("risingwave_tpu_torch.runtime.fragmenter", "sharded_planned_mv"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(name)
    import importlib

    value = getattr(importlib.import_module(entry[0]), entry[1])
    globals()[name] = value
    return value
