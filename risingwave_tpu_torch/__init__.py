"""risingwave_tpu_torch — the PyTorch/CUDA port of ``risingwave_tpu``.

The package mirrors ``risingwave_tpu`` path for path (so
``risingwave_tpu_torch/ops/hash_table.py`` ports
``risingwave_tpu/ops/hash_table.py``) and runs the same streaming
dataflow on an NVIDIA Hopper GPU:

- state is plain dataclasses of torch tensors (``HashTable``,
  ``AggState``, ``MvDeviceState``, ``StreamChunk``) instead of pytrees;
- the device kernels that XLA compiled from ``jax.numpy`` code are
  hand-written CUDA C++ for ``sm_90a`` (``csrc/``, built and bound by
  ``_kernels.py``). Beside each kernel sits a plain PyTorch version of
  the same function; a public function takes the plain version only
  for tensors on the CPU, and on CUDA tensors it launches the kernel
  or raises;
- state is updated in place where that saves memory (the JAX versions
  are pure and donate their inputs); each such function says so.

It imports torch and numpy only — never ``jax`` and nothing of
``risingwave_tpu`` (importing that package flips JAX's x64 mode for the
whole process). Host-only helpers it needs are copied here.

Every constructor and plan-building function takes an explicit ``device``. The default
is ``"cuda"``; with no CUDA device the entry points raise instead of
running on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    but absent, so no entry point silently falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch finds no CUDA "
            "device; pass device='cpu' explicitly to run the plain "
            "PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
