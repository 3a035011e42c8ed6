"""Vectorized hashing: compound keys and vnode partitioning (K1).

Port of ``risingwave_tpu/ops/hashing.py:29-134``, bit-exact with it.
Reference: src/common/src/hash/consistent_hash/vnode.rs:34,54-56 (256
virtual nodes) and src/common/src/hash/key.rs (compound hash keys).

A compound key is a tuple of typed lanes; each lane is cut into uint32
words (64-bit lanes into (lo, hi)), every word goes through murmur3's
fmix32 and a boost ``hash_combine`` chain, and two seeds give the
fingerprint pair of ``hash128``.

These are the plain PyTorch versions. torch on the CPU has no uint32
``+``, ``<<`` or ``>>``, so every uint32 value here is carried in an
int64 lane in [0, 2**32) and masked with ``& 0xFFFFFFFF`` after each
step. On the card the same chain runs inside kernel A
(``csrc/hashing.cuh``), where fingerprints are computed and stored, and
inside kernel AH (``csrc/vnode.cu``), which ``vnode_of`` and
``vnode_slice_masks`` launch on CUDA tensors (the rest of K1 and K33,
``risingwave_tpu/runtime/graph.py:172-177``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from risingwave_tpu_torch import _kernels

VNODE_COUNT = 256  # parity with VirtualNode::COUNT (vnode.rs:54-56)

M32 = 0xFFFFFFFF
SEED_FP2 = 0x5BD1E995
SEED_VNODE = 0xC0FFEE


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 without overflowing int64: multiply by the two
    16-bit halves of ``c`` (every intermediate stays below 2**49)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """fmix32 from murmur3 on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _split64(col: torch.Tensor) -> list:
    """64-bit lane -> (lo, hi) uint32 words via one bit view; word 0 is
    the least-significant one (little-endian, as ``hashing.py:40-49``)."""
    if not col.numel():  # an empty lane may carry a zero stride, which view refuses
        col = col.new_empty(0)
    words = col.contiguous().view(torch.int32).reshape(-1, 2).to(torch.int64) & M32
    return [words[:, 0], words[:, 1]]


def _canonical_float(col: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 and every NaN -> the one positive quiet NaN, so
    values equal under the total order hash equally."""
    col = torch.where(col == 0.0, torch.zeros_like(col), col)
    return torch.where(torch.isnan(col), torch.full_like(col, float("nan")), col)


def _to_u32_lanes(col: torch.Tensor) -> list:
    """Any supported key lane -> one or two uint32 word lanes (int64)."""
    if col.dtype == torch.bool:
        return [col.to(torch.int64)]
    if col.dtype == torch.float32:
        return [_canonical_float(col).view(torch.int32).to(torch.int64) & M32]
    if col.dtype == torch.float64:
        return _split64(_canonical_float(col))
    if col.dtype == torch.int64:
        return _split64(col)
    if col.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
        return [col.to(torch.int64) & M32]
    raise TypeError(f"unsupported key dtype {col.dtype}")


def hash_columns(cols: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Hash a compound key row-wise; uint32 values in an int64 lane."""
    h = torch.full(
        cols[0].shape, (0x811C9DC5 ^ seed) & M32, dtype=torch.int64,
        device=cols[0].device,
    )
    for c in cols:
        for words in _to_u32_lanes(c):
            h = h ^ ((_mix32(words) + 0x9E3779B9 + (h << 6) + (h >> 2)) & M32)
    return _mix32(h)


def hash128(cols: Sequence[torch.Tensor]) -> tuple:
    """Two independent 32-bit hashes (fingerprint + probe seed)."""
    return hash_columns(cols, seed=0), hash_columns(cols, seed=SEED_FP2)


def group_key_lanes(chunk, names: Sequence[str]) -> tuple:
    """Key lanes for GROUP BY with SQL NULL semantics: a nullable key
    contributes its value (zeroed where NULL) and its null lane, so all
    NULLs form one group distinct from the real zero."""
    lanes = []
    for name in names:
        col = chunk.col(name)
        if chunk.is_nullable(name):
            null = chunk.nulls[name]
            lanes.append(torch.where(null, torch.zeros_like(col), col))
            lanes.append(null)
        else:
            lanes.append(col)
    return tuple(lanes)


def vnode_of(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row -> virtual node in [0, 256), int32 (reference: vnode.rs:34)."""
    if cols[0].device.type == "cuda":
        return _vnode_of_cuda(cols)
    return _vnode_of_torch(cols)


def vnode_slice_masks(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                      n_down: int) -> torch.Tensor:
    """The hash dispatcher's (n_down, n) bool masks: row ``d`` is
    ``valid & (vnode % n_down == d)``, the reference's
    ``_vnode_slice_mask(cols, valid, n_down, d)`` for every ``d``."""
    if valid.device.type == "cuda":
        return _vnode_dispatch_cuda(cols, valid, n_down)
    return _vnode_slice_masks_torch(cols, valid, n_down)


def _vnode_of_torch(cols):
    return (hash_columns(cols, seed=SEED_VNODE) % VNODE_COUNT).to(torch.int32)


def _vnode_slice_masks_torch(cols, valid, n_down: int):
    dest = (_vnode_of_torch(cols) % n_down).to(torch.int64)
    downs = torch.arange(n_down, dtype=torch.int64, device=valid.device)
    return valid[None, :] & (dest[None, :] == downs[:, None])


def _vnode_lane_rows(cols, n: int, what: str) -> list:
    """(pointer, dtype code, element stride) of each 1-D key lane on the
    card; a dtype AH does not take raises (no plain fallback)."""
    if not 1 <= len(cols) <= 8:
        raise ValueError(f"{what}: takes 1 to 8 key lanes, got {len(cols)}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"{what}: key lanes must have shape ({n},)")
    # a one-row view is contiguous whatever the lane's stride
    _kernels.check_cuda(what, *(c[:1] for c in cols))
    return [(c.data_ptr(), _kernels.dtype_code(c), c.stride(0)) for c in cols]


def _vnode_of_cuda(cols):
    n = cols[0].shape[0]
    rows = _vnode_lane_rows(cols, n, "vnode_of")
    vnode = torch.empty(n, dtype=torch.int32, device=cols[0].device)
    _kernels.call("vnode_dispatch", "rw_vnode_of", _kernels.int64_rows(rows, 8), len(rows), n,
                  vnode.data_ptr())
    return vnode


def _vnode_dispatch_cuda(cols, valid, n_down: int):
    n = valid.shape[0]
    _kernels.check_cuda("vnode_dispatch", valid, n=n)
    if valid.dtype != torch.bool:
        raise TypeError("valid must be a bool lane")
    if n_down < 1:
        raise ValueError("n_down must be at least 1")
    rows = _vnode_lane_rows(cols, n, "vnode_dispatch")
    mask = torch.empty((n_down, n), dtype=torch.bool, device=valid.device)
    _kernels.call("vnode_dispatch", "rw_vnode_dispatch", _kernels.int64_rows(rows, 8), len(rows),
                  n, valid.data_ptr(), n_down, mask.data_ptr())
    return mask
