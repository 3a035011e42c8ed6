"""Vnode hash exchange — the shuffle between sharded fragments (K31).

Port of ``risingwave_tpu/parallel/exchange.py`` (``EXCHANGE_MESH_CONTRACT``
:40-44, ``dest_shard`` :47, ``exchange_cols`` :57, ``pack_buckets`` :69,
``exchange_chunk`` :111). Reference roles: ``HashDataDispatcher`` routing
rows by key vnode (src/stream/src/executor/dispatch.rs:683, vnode mapping
src/common/src/hash/consistent_hash/vnode.rs:34) and the exchange channel
between fragments (src/stream/src/executor/exchange/permit.rs:35).

The reference runs ``exchange_chunk`` inside a ``shard_map``: each shard
packs its rows into per-destination buckets of static capacity and one
``lax.all_to_all`` per lane moves bucket ``d`` of shard ``s`` to slot
``s`` of shard ``d``. The port keeps every shard of the mesh stacked on
one device (``sharded_agg.Mesh``), so the exchange takes the whole
stacked chunk ``(n, cap)`` at once and writes each row straight to where
the all_to_all lands it: ``out[d][s * bucket_cap + pos]``. On the card
that is kernel AI (``csrc/exchange.cu``, ``rw_exchange``), one launch:
the key lanes hashed with AH's chain, each row ranked among its tile's
rows of its destination by warp matching and placed after the same
source's earlier tiles by a decoupled look-back (so the slots equal the
reference's cumsum order), every lane written in runs per destination
into one buffer zeroed by one memset, the ``(n, n)`` routing counts and
the per-source overflow flag. On the CPU it is the plain version below,
the reference's algorithm.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.ops.hashing import (
    SEED_VNODE,
    VNODE_COUNT,
    _vnode_of_cuda,
    hash_columns,
)

# The exchange's contract (``exchange.py:33-44``): a sharded executor
# routes rows through ``dest_shard``, so a row's shard is
# ``vnode(key) % n_shards``, a pure function of the key lanes and the
# mesh size; rows cross shards in the exchange itself, never through
# host memory (here kernel AI's scatter takes the all_to_all's place).
DISPATCH_FN = "dest_shard"
EXCHANGE_COLLECTIVE = "all_to_all"
EXCHANGE_MESH_CONTRACT = {
    "dispatch_fn": DISPATCH_FN,
    "collective": EXCHANGE_COLLECTIVE,
    "vnode_count": VNODE_COUNT,
}

# most shards and lanes one launch of kernel AI takes
# (csrc/exchange.cu EX_MAX_SHARDS, EX_MAX_LANES, EX_MAX_KEYS)
MAX_SHARDS = 64
MAX_LANES = 64
MAX_KEYS = 8
# rows per tile of kernel AI (csrc/exchange.cu EX_TILE)
EX_TILE = 2048


def default_bucket_cap(chunk_cap: int, n_shards: int) -> int:
    """The reference's bucket when none is set (``sharded_agg.py:159``):
    room for twice a fair share of a source shard's rows."""
    return max(64, (2 * chunk_cap) // n_shards)


def dest_shard(key_lanes, n_shards: int) -> torch.Tensor:
    """Row -> owning shard ``vnode % n_shards`` (int32, the lanes'
    shape): 256 vnodes round-robin over the shards, so a mesh of another
    size only remaps vnodes. On the card the vnode is kernel AH's
    ``rw_vnode_of`` (the hash AI routes with)."""
    lanes = tuple(key_lanes)
    if lanes[0].device.type == "cuda":
        flat = tuple(k.reshape(-1) for k in lanes)
        return (_vnode_of_cuda(flat) % n_shards).reshape(lanes[0].shape)
    return _dest_shard_torch(lanes, n_shards)


def _dest_shard_torch(key_lanes, n_shards: int) -> torch.Tensor:
    """``dest_shard`` in plain PyTorch (any device)."""
    shape = key_lanes[0].shape
    flat = tuple(k.reshape(-1) for k in key_lanes)
    vnode = (hash_columns(flat, seed=SEED_VNODE) % VNODE_COUNT).to(torch.int32)
    return (vnode % n_shards).reshape(shape)


def exchange_cols(chunk: StreamChunk) -> Dict[str, torch.Tensor]:
    """The lanes the exchange ships: every column, the ops lane and each
    null lane as ``__null__<name>`` (``exchange.py:57``)."""
    cols = dict(chunk.columns)
    cols["__ops__"] = chunk.ops
    for name, lane in chunk.nulls.items():
        cols["__null__" + name] = lane
    return cols


def pack_buckets(chunk_cols: Dict[str, torch.Tensor], valid, dest, n_shards: int,
                 bucket_cap: int):
    """One shard's rows into ``(n_shards, bucket_cap)`` buffers per lane
    (``exchange.py:69``): a row's position in its destination's bucket is
    the number of earlier valid rows with that destination; rows past
    ``bucket_cap`` are dropped and unfilled slots hold zeros. Returns
    ``(buffers, valid_buffer, overflow, counts)``, ``counts`` the
    ``(n_shards,)`` int32 valid rows per destination. Plain PyTorch."""
    n = valid.shape[0]
    dev = valid.device
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = torch.zeros(n_shards, dtype=torch.int32, device=dev)
    for d in range(n_shards):
        m = valid & (dest == d)
        pos = torch.where(m, torch.cumsum(m.to(torch.int64), 0) - 1, pos)
        counts[d] = m.sum()
    overflow = (counts > bucket_cap).any()
    in_cap = valid & (pos < bucket_cap)
    drop = n_shards * bucket_cap
    idx = torch.where(in_cap, dest.to(torch.int64) * bucket_cap + pos, drop)

    def scatter(col):
        buf = torch.zeros(drop + 1, dtype=col.dtype, device=dev)
        buf[idx] = col  # positions are unique; every dropped row lands on the sink
        return buf[:drop].reshape(n_shards, bucket_cap)

    out = {name: scatter(col) for name, col in chunk_cols.items()}
    return out, scatter(in_cap), overflow, counts


def exchange_chunk(chunk: StreamChunk, key_lanes, n_shards: int, bucket_cap: int
                   ) -> Tuple[StreamChunk, torch.Tensor, torch.Tensor]:
    """Route a stacked chunk's rows to the shards owning their keys.

    ``chunk`` and ``key_lanes`` are stacked ``(n_shards, cap)`` (row ``s``
    is shard ``s``'s input). Returns ``(received, overflow, counts)``:
    ``received`` is stacked ``(n_shards, n_shards * bucket_cap)``, row
    ``d`` what shard ``d`` receives (rows from source ``s`` at
    ``[s * bucket_cap, (s + 1) * bucket_cap)``), ``overflow`` the
    ``(n_shards,)`` bool flag of each source shard with a bucket past
    ``bucket_cap``, ``counts`` the ``(n_shards, n_shards)`` int32
    routed valid rows (row: source, column: destination). Kernel AI on
    CUDA tensors, the plain version on CPU tensors."""
    if chunk.valid.dim() != 2 or chunk.valid.shape[0] != n_shards:
        raise ValueError(f"exchange_chunk: a stacked ({n_shards}, cap) chunk expected, got "
                         f"valid {tuple(chunk.valid.shape)}")
    key_lanes = tuple(key_lanes)
    lanes = exchange_cols(chunk)
    dev = chunk.valid.device
    if dev.type == "cpu":
        bufs, vbuf, overflow, counts = _exchange_torch(lanes, chunk.valid, key_lanes,
                                                       n_shards, bucket_cap)
    elif dev.type == "cuda":
        bufs, vbuf, overflow, counts = _exchange_cuda(lanes, chunk.valid, key_lanes,
                                                      n_shards, bucket_cap)
    else:
        raise ValueError(f"unsupported device {dev}")
    received = StreamChunk(
        columns={n: b for n, b in bufs.items() if n != "__ops__" and not n.startswith("__null__")},
        valid=vbuf,
        nulls={n[len("__null__"):]: b for n, b in bufs.items() if n.startswith("__null__")},
        ops=bufs["__ops__"],
    )
    return received, overflow, counts


def _exchange_torch(lanes, valid, key_lanes, n_shards: int, bucket_cap: int):
    """The reference's algorithm per source shard (``dest_shard``,
    ``pack_buckets``), then the all_to_all as a transpose of the
    ``(source, destination)`` bucket axes. Plain PyTorch on any device
    (``chip_smoke.py`` holds kernel AI against it on the card)."""
    dest = _dest_shard_torch(key_lanes, n_shards)
    per = [pack_buckets({n: a[s] for n, a in lanes.items()}, valid[s], dest[s], n_shards,
                        bucket_cap) for s in range(n_shards)]

    def all_to_all(bufs):  # (src, dst, bc) -> row dst = [src 0's bucket, src 1's, ...]
        return torch.stack(bufs).transpose(0, 1).reshape(n_shards, n_shards * bucket_cap)

    out = {n: all_to_all([p[0][n] for p in per]) for n in lanes}
    vbuf = all_to_all([p[1] for p in per])
    overflow = torch.stack([p[2] for p in per])
    counts = torch.stack([p[3] for p in per])
    return out, vbuf, overflow, counts


def _stacked_lane(name: str, a: torch.Tensor, n_shards: int, cap: int):
    """(a, shard stride) of a stacked lane AI can read in place: shape
    (n_shards, cap), rows contiguous, shards at any stride (0 for a lane
    broadcast to every shard); anything else is copied contiguous."""
    if a.shape != (n_shards, cap):
        raise ValueError(f"exchange: lane {name!r} has shape {tuple(a.shape)}, "
                         f"expected ({n_shards}, {cap})")
    if a.stride(1) != 1 and cap > 1:
        a = a.contiguous()
    return a, (a.stride(0) if n_shards > 1 else 0)


def exchange_scratch_words(n_shards: int, cap: int) -> int:
    """int32 words of AI's scratch: a look-back word per (source, tile,
    destination) and the tile counter (``csrc/exchange.cu``)."""
    return n_shards * max(1, -(-cap // EX_TILE)) * n_shards + 1


def exchange_buffer_layout(esizes, n_shards: int, width: int, cap: int):
    """Byte offsets of AI's one output buffer, each region 16-aligned: a
    ``(n_shards, width)`` region per lane of element size ``esizes[i]``,
    then valid and the scratch words; returns ``(lane offsets, valid,
    scratch, total bytes)``. One memset zeroes it all. The counts and the
    flags, which the kernel writes whole, sit in a small buffer of their
    own, so a caller keeping them does not keep the lanes alive."""
    up = lambda b: -(-b // 16) * 16
    slots = n_shards * width
    offs, at = [], 0
    for es in esizes:
        offs.append(at)
        at += up(slots * es)
    s_at = at + up(slots)
    return offs, at, s_at, s_at + 4 * exchange_scratch_words(n_shards, cap)


def _exchange_cuda(lanes, valid, key_lanes, n_shards: int, bucket_cap: int):
    """Kernel AI: one memset of one buffer that every output lane views,
    then one ``rw_exchange`` launch routes, places and writes every lane,
    the counts and the flags (``csrc/exchange.cu``)."""
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"exchange: 1 to {MAX_SHARDS} shards, got {n_shards}")
    if len(lanes) > MAX_LANES:
        raise ValueError(f"exchange: {len(lanes)} lanes exceed the kernel's {MAX_LANES}")
    if not 1 <= len(key_lanes) <= MAX_KEYS:
        raise ValueError(f"exchange: 1 to {MAX_KEYS} key lanes, got {len(key_lanes)}")
    if valid.dtype != torch.bool:
        raise TypeError("exchange: valid must be a bool lane")
    cap = valid.shape[1]
    width = n_shards * bucket_cap
    # every lane read by pointer (valid, keys, sources) is checked and
    # outlives the launch (_kernels.call)
    _kernels.check_device("exchange", valid, *key_lanes, *lanes.values())
    valid_l, valid_stride = _stacked_lane("valid", valid, n_shards, cap)
    keep_alive = [valid_l]
    key_rows = []
    for i, k in enumerate(key_lanes):
        k, stride = _stacked_lane(f"key {i}", k, n_shards, cap)
        keep_alive.append(k)
        key_rows.append((k.data_ptr(), _kernels.dtype_code(k), stride))
    srcs = []
    for name, a in lanes.items():
        a, stride = _stacked_lane(name, a, n_shards, cap)
        if a.element_size() not in (1, 4, 8):
            raise TypeError(f"exchange: lane {name!r} of dtype {a.dtype}")
        keep_alive.append(a)
        srcs.append((name, a, stride))
    offs, v_at, s_at, total = exchange_buffer_layout(
        [a.element_size() for _, a, _ in srcs], n_shards, width, cap)
    buf = torch.empty(total, dtype=torch.uint8, device=valid.device)
    view = lambda at, n, dtype: buf[at:at + n * dtype.itemsize].view(dtype)
    # counts, then the flags
    small = torch.empty(4 * n_shards * n_shards + n_shards, dtype=torch.uint8, device=valid.device)
    out, lane_rows = {}, []
    for (name, a, stride), at in zip(srcs, offs):
        o = view(at, n_shards * width, a.dtype).view(n_shards, width)
        out[name] = o
        lane_rows.append((a.data_ptr(), o.data_ptr(), a.element_size(), stride))
    vbuf = view(v_at, n_shards * width, torch.bool).view(n_shards, width)
    counts = small[:4 * n_shards * n_shards].view(torch.int32).view(n_shards, n_shards)
    overflow = small[4 * n_shards * n_shards:].view(torch.bool)
    base = buf.data_ptr()
    _kernels.call(
        "exchange", "rw_exchange", _kernels.int64_rows(key_rows, MAX_KEYS), len(key_rows),
        _kernels.int64_rows(lane_rows, MAX_LANES), len(lane_rows), n_shards, cap, bucket_cap,
        valid_l.data_ptr(), valid_stride, base + v_at, counts.data_ptr(), overflow.data_ptr(),
        base + s_at, base, total,
    )
    return out, vbuf, overflow, counts
