"""Build and bind the port's hand-written CUDA kernels.

The sources live in ``csrc/``; each ``.cu`` file is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface
under ``_build/`` (git-ignored) and loaded with ``ctypes``. The first
CUDA call of a kernel builds every library, all ``nvcc`` processes
started together; a library is named after a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Each wrapper passes tensor pointers and PyTorch's current stream, and
raises if the C entry point returns a CUDA error. ``LAUNCHES`` counts,
per kernel, the calls of its C entry points on the card: one per call of
A, C, D, E, F, G, H, J, L, M, N, O, P, Q, R, S, T, U, V, W, X, Y, Z,
AA, AB, AC, AD, AE, AF, AG, AH and AI (an entry point may launch several kernels in order on the stream),
two per call of B (the apply and its set_live), one per 24 lanes moved
by a call of I; the entry points of ``ENTRY_KEYS`` count under their
own names (S's ``rw_project`` under ``expr_eval``, its ``rw_filter``
under ``expr_filter``, X's ``rw_group_topk_mask`` under
``group_topk``, its ``rw_group_topk_fold`` under
``group_topk_fold`` and its ``rw_group_topk_long`` under
``group_topk_long``, Z's ``rw_dyn_left_step`` under ``dyn_general`` and
its ``rw_dyn_rv_diff`` under ``dyn_rv_diff``, AA's ``rw_unnest``,
``rw_series`` and ``rw_expand`` under ``unnest``, ``series`` and
``expand``, AC's ``rw_arena_append`` under ``arena`` and its
``rw_arena_emit`` under ``arena_emit``, AD's ``rw_over_step`` under
``over_step``, AE's ``rw_window_fold`` under ``window_fold``, its
``rw_window_order`` under ``window_order``, its ``rw_window_calls`` under
``window_calls`` and its sort alone (``rw_onesweep_sort``) under
``onesweep``, AF's ``rw_over_apply`` under
``over_apply`` and its ``rw_over_diff`` under ``over_diff``, AG's
``rw_cold_select`` under ``cold_select`` and its ``rw_cold_merge`` under
``cold_merge``, AH's ``rw_vnode_dispatch`` under ``vnode_dispatch`` and
its ``rw_vnode_of`` under ``vnode_of``; a Project whose outputs are
all bare columns launches nothing).

Parallel actors launch from several threads at once: ``library`` loads
each library under a lock, and ``LAUNCHES`` counts under another.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> its source in csrc/
SOURCES = {
    "lookup_or_insert": "lookup_or_insert.cu",
    "agg_apply": "agg_apply.cu",
    "agg_flush": "agg_flush.cu",
    "mv_upsert": "mv_upsert.cu",
    "hop_expand": "hop_expand.cu",
    "reduce_by_key": "reduce_by_key.cu",
    "apply_reduced": "apply_reduced.cu",
    "state_digest": "state_digest.cu",
    "slot_move": "slot_move.cu",
    "dedup_emit": "dedup_emit.cu",
    "join_apply": "join_apply.cu",
    "join_probe": "join_probe.cu",
    "join_degree": "join_degree.cu",
    "dyn_filter": "dyn_filter.cu",
    "expire": "expire.cu",
    "minput": "minput.cu",
    "checkpoint": "checkpoint.cu",
    "expr_eval": "expr_eval.cu",
    "wm_filter": "wm_filter.cu",
    "topn_band": "topn_band.cu",
    "topn_upsert": "topn_upsert.cu",
    "topn_rank": "topn_rank.cu",
    "simple_agg": "simple_agg.cu",
    "dyn_general": "dyn_general.cu",
    "tile_expand": "tile_expand.cu",
    "temporal_probe": "temporal_probe.cu",
    "arena": "arena.cu",
    "over_step": "over_step.cu",
    "window_calls": "window_calls.cu",
    "over_diff": "over_diff.cu",
    "cold_tier": "cold_tier.cu",
    "vnode_dispatch": "vnode.cu",
    "exchange": "exchange.cu",
}

# C entry points: (argtypes,) — every pointer and the stream as c_void_p
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "lookup_or_insert": {
        "rw_lookup_or_insert": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P],
    },
    "agg_apply": {
        "rw_agg_apply": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P],
        "rw_agg_set_live": [_L, _P, _P, _P, _P],
    },
    "agg_flush": {
        "rw_agg_flush": [_P, _I, _P, _I, _P, _L, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    },
    "mv_upsert": {
        "rw_mv_upsert": [_P, _I, _P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "hop_expand": {
        "rw_hop_expand": [_P, _I, _L, _L, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P],
    },
    "reduce_by_key": {
        "rw_reduce_by_key": [_P, _I, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _P],
    },
    "apply_reduced": {
        "rw_apply_reduced": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "state_digest": {
        "rw_state_digest": [_P, _I, _L, _P, _P, _P, _P, _I, _P, _P, _P],
    },
    "slot_move": {
        "rw_slot_move": [_P, _I, _L, _P, _P, _P],
    },
    "dedup_emit": {
        "rw_first_occurrence": [_L, _P, _P, _P, _L, _P, _P],
        "rw_dedup_emit": [_L, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    },
    "join_apply": {
        "rw_join_apply": [_P, _I, _L, _P, _P, _P, _I] + [_P] * 12 + [_L, _P],
        "rw_join_regrow": [_P, _I, _L, _I, _I, _P, _P, _P, _P, _P],
    },
    "join_probe": {
        "rw_lookup": [_P, _I, _L, _P, _P, _P, _P, _L, _P, _P, _P],
        "rw_join_probe": [_P, _I, _L, _P, _P, _P, _P, _P, _L, _P, _I, _P, _I, _I]
        + [_P] * 8 + [_I, _I, _P],
    },
    "join_degree": {
        "rw_join_degree": [_L, _P, _P, _P, _I, _L, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                           _L, _P, _P],
    },
    "dyn_filter": {
        "rw_dyn_filter": [_L, _P, _P, _P, _P, _P, _I, _P, _P, _P, _L, _P, _P, _P, _P],
    },
    "expire": {
        "rw_expire_keys": [_L, _P, _P, _I, _L, _P, _P],
        "rw_expire_join": [_L, _P, _P, _I, _L, _P, _P, _P, _I, _P],
        "rw_expire_agg": [_L, _P, _P, _I, _L, _P, _P, _P, _P, _I, _P, _I, _P],
    },
    "minput": {
        "rw_minput_apply": [_L, _P, _P, _P, _I, _P, _I, _P, _I, _P, _L, _I, _P, _P, _P, _P, _L,
                            _P, _L, _P],
        "rw_minput_clear": [_L, _P, _P, _L, _I, _P],
        "rw_minput_rescatter": [_L, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    },
    "checkpoint": {
        "rw_stage_select": [_P, _P, _P, _P, _P, _I, _P, _L, _P, _P, _P, _P, _P],
        "rw_gather_rows": [_P, _I, _P, _L, _P],
        "rw_scatter_rows": [_P, _I, _P, _L, _P],
        "rw_mark_checkpointed": [_P, _P, _L, _P, _P, _P, _L, _P],
    },
    "expr_eval": {
        "rw_project": [_P, _I, _L, _P, _P, _P],
        "rw_filter": [_P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P],
    },
    "wm_filter": {
        "rw_wm_step": [_L, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    },
    "topn_band": {
        "rw_topn_step": [_P, _I, _P, _I, _L, _I, _L, _L, _P, _P, _P, _P, _P, _I, _I]
        + [_P] * 13,
    },
    "topn_upsert": {
        "rw_topn_upsert": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "topn_rank": {
        "rw_rank_fold": [_P, _I, _L, _P, _P, _P],
        "rw_rank_select": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P],
        "rw_rank_top": [_P, _I, _L, _P, _P, _L, _P, _L, _P, _P, _P],
        "rw_group_topk_fold": [_P, _I, _I, _L, _P, _P, _P, _P, _P, _P],
        "rw_group_topk_mask": [_P, _I, _I, _L, _P, _P, _I, _P, _P, _L] + [_P] * 9,
        "rw_group_topk_long": [_P, _I, _I, _I, _I, _P, _P, _L, _L, _L] + [_P] * 8,
    },
    "simple_agg": {
        "rw_simple_apply": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P],
    },
    "dyn_general": {
        "rw_dyn_left_step": [_P, _I, _L, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             _P],
        "rw_dyn_rv_diff": [_L, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "tile_expand": {
        "rw_unnest": [_P, _I, _P, _I, _I, _L, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
        "rw_series": [_P, _I, _I, _L, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        "rw_expand": [_P, _I, _I, _L, _P, _P, _P, _P, _P, _P],
    },
    "temporal_probe": {
        "rw_temporal_probe": [_P, _I, _L, _P, _P, _P, _P, _P, _L, _P, _I, _I, _P, _P],
    },
    "arena": {
        "rw_arena_append": [_P, _I, _L, _L] + [_P] * 13,
        "rw_arena_emit": [_P, _I, _L, _L] + [_P] * 14,
    },
    "over_step": {
        "rw_over_step": [_P, _P, _I, _L, _L] + [_P] * 15,
    },
    "window_calls": {
        "rw_window_fold": [_L, _L, _P, _P, _P, _L, _P, _P, _P, _P, _I, _P, _P, _P, _P],
        "rw_window_order": [_L, _L, _P, _P, _P, _L, _P, _P, _P, _P, _I, _P, _L] + [_P] * 11,
        "rw_window_calls": [_L, _L, _P, _P, _P, _I, _L, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                            _P, _P, _P, _I, _P, _P, _I, _P, _L, _P, _P],
        "rw_onesweep_sort": [_P, _P, _L, _I] + [_P] * 8,
    },
    "over_diff": {
        "rw_over_apply": [_P, _I, _P, _I, _L, _L] + [_P] * 6 + [_L] + [_P] * 11,
        "rw_over_diff": [_P, _I, _L] + [_P] * 8,
    },
    "cold_tier": {
        "rw_cold_select": [_I, _L] + [_P] * 12 + [_P],
        "rw_cold_merge": [_P, _I, _P, _L, _P, _P, _P],
    },
    "vnode_dispatch": {
        "rw_vnode_of": [_P, _I, _L, _P, _P],
        "rw_vnode_dispatch": [_P, _I, _L, _P, _I, _P, _P],
    },
    "exchange": {
        "rw_exchange": [_P, _I, _P, _I, _I, _L, _L, _P, _L, _P, _P, _P, _P, _P, _L, _P],
    },
}

# slots per block of the stream compaction of kernels R and Z
# (csrc/compact.cuh COMPACT_TILE)
COMPACT_TILE = 4096


def compact_scratch(cap: int, device) -> torch.Tensor:
    """The int32 tile counts of one compaction over ``cap`` slots (their
    total after them)."""
    return torch.empty(-(-cap // COMPACT_TILE) + 1, dtype=torch.int32, device=device)


# lanes one gather or scatter of kernel R takes (csrc/checkpoint.cu CK_MAX_LANES)
CHECKPOINT_LANES = 32
# lanes one launch of kernel E or AA tiles (csrc/tile.cuh RW_TILE_MAX_LANES)
TILE_LANES = 32

# keys per block of the radix pass (RBK_TILE in csrc/radix.cuh), which
# sizes the scratch of kernels X, AC's emit and AD
RBK_TILE = 2048
# keys per tile of the single-sweep radix pass (csrc/onesweep.cuh
# OS_TILE), which sizes the look-back words of kernel AE's, W's and F's
# sorts (and F's reduce tiles)
OS_TILE = 2048
# elements per block of the device-wide scan (csrc/scan.cuh SCAN_TILE)
SCAN_TILE = 2048
# elements per block of the segmented scan of kernels AD and AE
# (csrc/segscan.cuh SEG_SCAN_TILE)
SEG_SCAN_TILE = 1024
# blocks of the state digest's first pass (csrc/state_digest.cu SD_BLOCKS)
DIGEST_BLOCKS = 1024
# lanes one slot_move launch takes (csrc/slot_move.cu SM_MAX_LANES)
SLOT_MOVE_LANES = 24
# accumulator and non-null lanes one rw_expire_agg call takes
# (csrc/expire.cu EX_MAX_LANES less its four fixed lanes)
EXPIRE_AGG_LANES = 20

# lane dtype codes shared with csrc/common.cuh (RwDType)
DTYPE_CODES = {
    torch.bool: 0,
    torch.int32: 1,
    torch.int64: 2,
    torch.float32: 3,
    torch.float64: 4,
}

# entry points counted apart from their library's main entry: they are
# not on a main path at every size (a lookup alone, a first-occurrence
# mask alone, a join side's rebuild), or one state kind's expiry of
# kernel O (its key-table entry counts as "expire"), or kernel Q's clear
# and rescatter of a materialized MIN/MAX multiset (its apply counts as
# "minput"), or kernel R's gather, mark and scatter (its stage select
# counts as "checkpoint"), or kernel S's filter (its projection counts
# as "expr_eval"), or kernel X's two entries (its mask counts as
# "group_topk", its fold as "group_topk_fold"; W's fold and select as
# "rank_fold" and "rank_select", its last entry as "topn_rank"),
# or kernel Z's right-value diff (its left step counts as "dyn_general"),
# or one of kernel AA's three table-function entries
# (each counts under its own name; "tile_expand" itself stays 0), or
# kernel AC's emit (its append counts as "arena"), AE's fold, order and
# sort alone (its calls count as "window_calls"), AF's apply (its diff counts as "over_diff"),
# or one of kernel AG's two cold-tier entries (each under its own name;
# "cold_tier" itself stays 0), or AH's vnode lane alone (a restore's
# routing; its dispatch masks count as "vnode_dispatch")
ENTRY_KEYS = {
    "rw_lookup": "lookup",
    "rw_first_occurrence": "first_occurrence",
    "rw_join_regrow": "join_regrow",
    "rw_expire_join": "expire_join",
    "rw_expire_agg": "expire_agg",
    "rw_minput_clear": "minput_clear",
    "rw_minput_rescatter": "minput_rescatter",
    "rw_gather_rows": "gather_rows",
    "rw_mark_checkpointed": "mark_checkpointed",
    "rw_scatter_rows": "scatter_rows",
    "rw_filter": "expr_filter",
    "rw_group_topk_mask": "group_topk",
    "rw_group_topk_fold": "group_topk_fold",
    "rw_group_topk_long": "group_topk_long",
    "rw_rank_fold": "rank_fold",
    "rw_rank_select": "rank_select",
    "rw_dyn_rv_diff": "dyn_rv_diff",
    "rw_unnest": "unnest",
    "rw_series": "series",
    "rw_expand": "expand",
    "rw_arena_emit": "arena_emit",
    "rw_window_fold": "window_fold",
    "rw_window_order": "window_order",
    "rw_onesweep_sort": "onesweep",
    "rw_over_apply": "over_apply",
    "rw_cold_select": "cold_select",
    "rw_cold_merge": "cold_merge",
    "rw_vnode_of": "vnode_of",
}

LAUNCHES = {name: 0 for name in (*SOURCES, *ENTRY_KEYS.values())}

_LIBS: dict = {}
_LIBS_LOCK = threading.Lock()
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library (one nvcc per source, all started
    together); returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIBS_LOCK:  # two actors' first launches must not both run nvcc
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def call(name: str, fn: str, *args) -> None:
    """Launch ``fn`` of kernel ``name`` on the current stream (the stream
    is appended as the last argument), raise on a CUDA error, and count
    the launch.

    The caller must hold a reference to every tensor whose ``data_ptr``
    it passes until this returns: the launch is only enqueued, and a
    tensor freed before then (a temporary cast, say) returns its block
    to PyTorch's caching allocator, which may hand it to the next
    allocation on the stream and have it overwritten before the kernel
    reads it. Blocks freed after ``call`` returns are safe, since the
    allocator reuses them only in stream order."""
    # the raw handle: torch.cuda.current_stream() builds a Stream object
    # a launch (about 9 us of host time on the card's machine)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = getattr(library(name), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[ENTRY_KEYS.get(fn, name)] += 1


def int64_rows(rows, max_rows: int) -> ctypes.Array:
    """A flat host int64 array of descriptor rows (pointers, codes) that
    a C entry point copies into its kernel's by-value argument, which
    holds at most ``max_rows`` of them."""
    if len(rows) > max_rows:
        raise ValueError(f"{len(rows)} lanes exceed the kernel's {max_rows}")
    flat = array.array("q", [int(v) for row in rows for v in row] or [0])
    return (ctypes.c_int64 * len(flat)).from_buffer(flat)


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel lanes do not take dtype {t.dtype}")
    return code


def check_device(name: str, *tensors) -> None:
    """Every tensor on one CUDA device (any shape and strides); raise
    otherwise."""
    dev = tensors[0].get_device()  # -1 on the CPU
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")


def check_cuda(name: str, *tensors, n=None) -> None:
    """Every tensor on one CUDA device, contiguous, and (if ``n`` is
    given) of length ``n``; raise otherwise."""
    dev = tensors[0].get_device()  # -1 on the CPU
    for t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if n is not None and t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
