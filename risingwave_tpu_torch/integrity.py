"""State digests: an order-insensitive fold over an executor's durable
state lanes.

Port of the digest half of ``risingwave_tpu/integrity.py`` (``GOLD``
:52, ``U64_MASK`` :55, ``crc32_bytes`` :151, the numpy fold
``lane_seed``/``_np_slot_words``/``_np_mix``/``host_digest`` :268-310,
``device_digest`` :329, ``digest_from_scalar`` :371, ``agg_lanes``
:386, ``mv_lanes`` :404, ``dedup_lanes`` :414, ``filter_lanes``
:419, ``join_side_lanes`` :426) and its checkpoint half
(``digest_enabled`` :58, ``StateCorruption`` :68, the host counters
and ``note_corruption`` :110-150, ``verify_crc`` :155, ``quarantine``
:170, ``raise_corruption`` :185, the manifest envelope
``encode_manifest``/``decode_manifest`` :210-266, ``host_rows_digest``
:313, ``host_obj_digest`` :446), whose host code is copied.

The contract, shared by every fold here and by the reference:

- per lane, slots are split into little-endian uint32 words (bool and
  sub-4-byte ints promote to uint32 first; a 2-D lane contributes the
  words of its whole row);
- a per-slot running hash ``h`` mixes the lane-name seed
  (``crc32(name)``) and then every word: ``h = (h ^ w) * GOLD;
  h ^= h >> 15``, all in uint32;
- lanes fold in sorted-name order, dead slots mask to 0, and the slots
  reduce to (wrapping uint32 sum, uint32 xor) packed as
  ``(sum << 32) | xor`` — commutative over slots, so the digest does not
  depend on slot placement, rehash or growth.

``host_digest`` is the numpy fold (a copy of the reference's).
``device_digest`` is kernel H on the card (``csrc/state_digest.cu``) and
its plain PyTorch version on the CPU; both return the packed uint64
bitcast to a () int64 tensor, so it rides the fused program's staged
int64 scalar lane. A lane given as ``Masked(lane, entries)`` folds as
``where(entries, lane, 0)``: a join side's (capacity, fanout) bucket
lanes masked by ``row_valid``, which kernel H reads entry by entry
instead of materialising the masked copies.
"""

from __future__ import annotations

import json
import math
import os
import time
import zlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from risingwave_tpu_torch import _kernels
from risingwave_tpu_torch.ops.agg import order_key_to_reference_lane
from risingwave_tpu_torch.ops.hashing import M32, _mul32

GOLD = 0x9E3779B1  # 2**32 / golden ratio — Fibonacci-hash multiplier
MANIFEST_FORMAT = 2
QUARANTINE_PREFIX = "quarantine"
U64_MASK = (1 << 64) - 1

_DIGEST_DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32, torch.float64)


# lanes one kernel-H digest folds (csrc/state_digest.cu SD_MAX_LANES)
DIGEST_LANES = 40


def digest_enabled() -> bool:
    """Manifest-level table digests are opt-in (``RW_STATE_DIGEST=1``):
    they re-read every table at commit (a whole-table store scan). The
    fused digest lanes are always on."""
    v = os.environ.get("RW_STATE_DIGEST", "")
    return v.strip().lower() not in ("", "0", "off", "false")


class StateCorruption(RuntimeError):
    """A checksum or digest mismatch: the bytes parse but are WRONG.

    RuntimeError on purpose — ``CheckpointManager._read_transient``
    classifies ``(OSError, ValueError)`` as retryable store weather,
    and a wrong byte must never ride that loop. The artifact named here
    has already been copied to ``quarantine/`` when a store was at
    hand."""

    def __init__(
        self,
        artifact: str,
        kind: str,
        detail: str = "",
        expected=None,
        actual=None,
        quarantined: Optional[str] = None,
    ):
        self.artifact = artifact
        self.kind = kind
        self.detail = detail
        self.expected = expected
        self.actual = actual
        self.quarantined = quarantined
        msg = f"state corruption in {artifact!r} [{kind}]"
        if expected is not None or actual is not None:
            msg += f" expected={expected!r} actual={actual!r}"
        if detail:
            msg += f": {detail}"
        if quarantined:
            msg += f" (quarantined at {quarantined!r})"
        super().__init__(msg)


# -- host-cost accounting ------------------------------------------------------
_HOST = {"ms": 0.0, "checks": 0, "corruptions": 0}


def host_ms() -> float:
    """Cumulative host milliseconds spent verifying crcs and folding
    digests since the last ``reset_host_ms()``."""
    return _HOST["ms"]


def reset_host_ms() -> None:
    _HOST["ms"] = 0.0
    _HOST["checks"] = 0


def corruption_count() -> int:
    return _HOST["corruptions"]


def note_corruption(exc: "StateCorruption") -> None:
    _HOST["corruptions"] += 1
    try:
        from risingwave_tpu_torch.event_log import EVENT_LOG

        EVENT_LOG.record(
            "state_corruption",
            artifact=exc.artifact,
            fault=exc.kind,
            quarantined=exc.quarantined,
            detail=exc.detail[:200],
        )
        from risingwave_tpu_torch.metrics import REGISTRY

        REGISTRY.counter("integrity_corruptions_total").inc(kind=exc.kind)
    except Exception:  # noqa: BLE001 — observability never masks the fault
        pass


# -- crc layer -----------------------------------------------------------------
def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def verify_crc(data: bytes, expected: int, artifact: str, kind: str = "crc") -> None:
    """Verify ``data`` against a build-time crc; raise StateCorruption
    (not quarantined here — the caller owns the store handle)."""
    t0 = time.perf_counter()
    got = crc32_bytes(data)
    _HOST["ms"] += (time.perf_counter() - t0) * 1e3
    _HOST["checks"] += 1
    if got != (expected & 0xFFFFFFFF):
        raise StateCorruption(artifact, kind, expected=expected, actual=got)


def quarantine(store, path: str, data: Optional[bytes] = None) -> Optional[str]:
    """Copy the corrupt artifact aside for forensics — never delete the
    original (walk-back recovery simply stops referencing it). Returns
    the quarantine path, or None when even the copy failed."""
    qpath = f"{QUARANTINE_PREFIX}/{path}"
    try:
        if data is None:
            data = store.read(path)
        store.put(qpath, data)
        return qpath
    except Exception:  # noqa: BLE001
        return None


def raise_corruption(
    store,
    artifact: str,
    kind: str,
    data: Optional[bytes] = None,
    detail: str = "",
    expected=None,
    actual=None,
):
    """Quarantine + event + raise, in one motion (the storage layer's
    single exit ramp for a detected wrong byte)."""
    q = quarantine(store, artifact, data) if store is not None else None
    exc = StateCorruption(
        artifact, kind, detail=detail, expected=expected, actual=actual, quarantined=q,
    )
    note_corruption(exc)
    raise exc


# -- manifest envelope (format 2): {"format": 2, "crc32": c, "payload": version}
def encode_manifest(version: dict) -> bytes:
    payload = json.dumps(version, sort_keys=True)
    return json.dumps(
        {
            "format": MANIFEST_FORMAT,
            "crc32": crc32_bytes(payload.encode()),
            "payload": version,
        }
    ).encode()


def decode_manifest(raw: bytes, artifact: str = "MANIFEST") -> dict:
    """Decode + verify a manifest blob. Raises StateCorruption on a
    torn tail (truncated JSON) or a crc mismatch. A pre-envelope
    (format-1) manifest decodes as-is."""
    try:
        doc = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise StateCorruption(artifact, "torn-manifest", detail=str(e)) from None
    if isinstance(doc, dict) and doc.get("format") == MANIFEST_FORMAT and "payload" in doc:
        payload = doc["payload"]
        want = doc.get("crc32")
        t0 = time.perf_counter()
        got = crc32_bytes(json.dumps(payload, sort_keys=True).encode())
        _HOST["ms"] += (time.perf_counter() - t0) * 1e3
        _HOST["checks"] += 1
        if got != want:
            raise StateCorruption(artifact, "manifest-crc", expected=want, actual=got)
        return payload
    if isinstance(doc, dict) and not any(k in doc for k in ("format", "crc32", "payload")):
        return doc  # legacy format-1: no envelope, no checksum
    # envelope fields present but the envelope does not verify as one: a
    # flipped bit in "format" or "payload" must not launder the blob
    # through the legacy path
    raise StateCorruption(
        artifact, "manifest-format", detail="envelope fields present but malformed"
    )


def lane_seed(name: str) -> int:
    return crc32_bytes(name.encode("utf-8"))


# -- the numpy fold (copied from the reference) ------------------------------
def _np_slot_words(arr: np.ndarray) -> np.ndarray:
    """(capacity, ...) lane -> (capacity, words) little-endian uint32."""
    a = np.ascontiguousarray(arr)
    n = a.shape[0] if a.ndim else 0
    if a.dtype == np.bool_ or a.dtype.itemsize < 4:
        a = a.astype(np.uint32)
    if a.ndim > 1:
        a = np.ascontiguousarray(a.reshape(n, -1))
    w = a.view(np.uint32)
    return w.reshape(n, -1)


def _np_mix(h: np.ndarray, w) -> np.ndarray:
    h = (h ^ w) * np.uint32(GOLD)
    return h ^ (h >> np.uint32(15))


def host_digest(lanes: Dict[str, np.ndarray], live=None) -> int:
    """The numpy fold: the packed ``(sum<<32)|xor`` digest as a python
    int in [0, 2**64)."""
    t0 = time.perf_counter()
    names = sorted(lanes)
    if not names:
        return 0
    first = np.asarray(lanes[names[0]])
    n = first.shape[0] if first.ndim else 0
    h = np.zeros(n, np.uint32)
    for name in names:
        h = _np_mix(h, np.uint32(lane_seed(name)))
        w = _np_slot_words(np.asarray(lanes[name]))
        for j in range(w.shape[1]):
            h = _np_mix(h, w[:, j])
    if live is not None:
        h = np.where(np.asarray(live, dtype=bool), h, np.uint32(0))
    s = int(h.astype(np.uint64).sum()) & 0xFFFFFFFF
    x = int(np.bitwise_xor.reduce(h)) if n else 0
    _HOST["ms"] += (time.perf_counter() - t0) * 1e3
    return (s << 32) | x


def host_rows_digest(keys: Dict[str, np.ndarray], values: Dict[str, np.ndarray]) -> int:
    """Digest of a table's durable row image (what ``read_table``
    returns): the manifest-level digest. Order-insensitive over rows,
    so compaction and merge order cannot move it."""
    lanes = dict(keys)
    lanes.update(values)
    return host_digest(lanes, live=None)


def host_obj_digest(obj) -> int:
    """Digest of a host-side state object via its canonical JSON bytes
    (sort_keys, default=str), for state held in python dicts rather than
    lanes."""
    t0 = time.perf_counter()
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    c = crc32_bytes(blob)
    c2 = crc32_bytes(blob[::-1])
    _HOST["ms"] += (time.perf_counter() - t0) * 1e3
    return (c << 32) | c2


def digest_from_scalar(v) -> int:
    """A staged int64 digest scalar back in the uint64 domain (the host
    fold's return type) for equality compares."""
    return int(v) & U64_MASK


# -- the device fold -----------------------------------------------------------
class Masked(NamedTuple):
    """A (capacity, fanout, ...) lane folded as ``where(entries, lane,
    0)``, ``entries`` a (capacity, fanout) bool lane."""

    lane: torch.Tensor
    entries: torch.Tensor


def _apply_entries(a) -> torch.Tensor:
    """A ``Masked`` lane materialised (the plain version's way)."""
    if not isinstance(a, Masked):
        return a
    m = a.entries.reshape(a.entries.shape + (1,) * (a.lane.dim() - a.entries.dim()))
    return torch.where(m, a.lane, torch.zeros((), dtype=a.lane.dtype, device=a.lane.device))


def _lane_of(a) -> torch.Tensor:
    return a.lane if isinstance(a, Masked) else a


def _masks(live) -> Tuple[torch.Tensor, ...]:
    if live is None:
        return ()
    if isinstance(live, torch.Tensor):
        return (live,)
    return tuple(live)


def device_digest(lanes: Dict[str, torch.Tensor], live=None) -> torch.Tensor:
    """The fold over torch lanes, as a () int64 tensor on their device.

    ``live`` is None (every slot counts), a bool lane, or a tuple of
    bool lanes whose OR is the mask (so the agg's ``live |
    emitted_valid`` is read inside kernel H rather than materialised).
    """
    masks = _masks(live)
    names = sorted(lanes)
    if not names:
        dev = masks[0].device if masks else torch.device("cpu")
        return torch.zeros((), dtype=torch.int64, device=dev)
    dev = _lane_of(lanes[names[0]]).device
    if dev.type == "cpu":
        return _device_digest_torch(lanes, names, masks)
    if dev.type == "cuda":
        return _device_digest_cuda(lanes, names, masks)
    raise ValueError(f"unsupported device {dev}")


def _slot_words(a: torch.Tensor) -> torch.Tensor:
    """(capacity, ...) lane -> (capacity, words) uint32 values in int64."""
    n = a.shape[0]
    row = a.contiguous().reshape(n, math.prod(a.shape[1:]))
    if a.dtype == torch.bool:
        return row.to(torch.int64)
    if a.dtype not in _DIGEST_DTYPES:
        raise TypeError(f"digest lanes do not take dtype {a.dtype}")
    w = row.view(torch.int32)
    return w.to(torch.int64) & M32


def _mix(h: torch.Tensor, w) -> torch.Tensor:
    h = _mul32(h ^ w, GOLD)
    return h ^ (h >> 15)


def _xor_reduce(h: torch.Tensor) -> int:
    while h.numel() > 1:
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        h = h[0::2] ^ h[1::2]
    return int(h[0]) if h.numel() else 0


def _device_digest_torch(lanes, names, masks) -> torch.Tensor:
    first = _lane_of(lanes[names[0]])
    n = first.shape[0]
    h = torch.zeros(n, dtype=torch.int64, device=first.device)
    for name in names:
        h = _mix(h, lane_seed(name))
        w = _slot_words(_apply_entries(lanes[name]))
        for j in range(w.shape[1]):
            h = _mix(h, w[:, j])
    if masks:
        keep = masks[0].clone()
        for m in masks[1:]:
            keep |= m
        h = torch.where(keep, h, torch.zeros_like(h))
    s = int(h.sum()) & M32
    packed = ((s << 32) | _xor_reduce(h)) & U64_MASK
    if packed >= 1 << 63:
        packed -= 1 << 64
    return torch.tensor(packed, dtype=torch.int64, device=first.device)


def digest_with_survivors(lanes: Dict[str, torch.Tensor], live: torch.Tensor,
                          sdirty: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``device_digest(lanes, live)`` and the count of slots in ``live |
    sdirty`` (a rebuild's survivors), both () int64 tensors: one pass of
    kernel H on the card, the plain fold and a reduction on the CPU."""
    names = sorted(lanes)
    dev = live.device
    if dev.type == "cpu":
        return _device_digest_torch(lanes, names, (live,)), (live | sdirty).sum()
    if dev.type == "cuda":
        count = torch.empty((), dtype=torch.int64, device=dev)
        return _device_digest_cuda(lanes, names, (live,), sdirty, count), count
    raise ValueError(f"unsupported device {dev}")


def _device_digest_cuda(lanes, names, masks, count_of=None, count_out=None) -> torch.Tensor:
    cap = _lane_of(lanes[names[0]]).shape[0]
    rows = []
    for name in names:
        a, entries = lanes[name], None
        if isinstance(a, Masked):
            a, entries = a
        if a.dtype not in _DIGEST_DTYPES:
            raise TypeError(f"digest lanes do not take dtype {a.dtype}")
        _kernels.check_cuda("state_digest", a)
        if a.dim() == 0 or a.shape[0] != cap:
            raise ValueError(f"state_digest: lane {name!r} is not ({cap}, ...)")
        cols = math.prod(a.shape[1:])
        words = cols if a.dtype == torch.bool else cols * a.element_size() // 4
        emask, entry_words = 0, 0
        if entries is not None:
            if entries.dtype != torch.bool or entries.shape != a.shape[:entries.dim()]:
                raise ValueError(f"state_digest: entry mask of {name!r} is not bool {a.shape[:2]}")
            _kernels.check_cuda("state_digest", a, entries)
            emask, entry_words = entries.data_ptr(), words // entries[0].numel()
        rows.append((a.data_ptr(), words, int(a.dtype == torch.bool), lane_seed(name),
                     emask, entry_words))
    if len(masks) > 2:
        raise ValueError("state_digest: at most two mask lanes")
    for m in masks + (() if count_of is None else (count_of,)):
        if m.dtype != torch.bool:
            raise TypeError("state_digest: masks must be bool lanes")
        _kernels.check_cuda("state_digest", m, n=cap)
    dev = _lane_of(lanes[names[0]]).device
    partials = torch.empty(3 * _kernels.DIGEST_BLOCKS, dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    m0 = masks[0].data_ptr() if masks else 0
    m1 = masks[1].data_ptr() if len(masks) > 1 else 0
    _kernels.call(
        "state_digest", "rw_state_digest",
        _kernels.int64_rows(rows, DIGEST_LANES), len(rows), cap, m0, m1,
        0 if count_of is None else count_of.data_ptr(), partials.data_ptr(),
        _kernels.DIGEST_BLOCKS, out.data_ptr(), 0 if count_out is None else count_out.data_ptr(),
    )
    return out


# -- per-executor lane builders ------------------------------------------------
def agg_lanes(table, state, float_extremes: Sequence = ()) -> Tuple[dict, tuple]:
    """HashAgg: keys + row_count + accums + nonnull + emitted snapshots,
    masked by ``live | emitted_valid``. Float MIN/MAX lanes (listed in
    ``float_extremes``, as ``ops.agg.float_extreme_meta`` gives them)
    are folded in the reference's unsigned key representation, so the
    digest equals the reference's."""
    fx = dict(float_extremes)

    def acc(name, a):
        return order_key_to_reference_lane(a, fx[name]) if name in fx else a

    lanes = {f"k{i}": k for i, k in enumerate(table.keys)}
    lanes["row_count"] = state.row_count
    for nm, a in state.accums.items():
        lanes[f"acc_{nm}"] = acc(nm, a)
    for nm, a in state.nonnull.items():
        lanes[f"nn_{nm}"] = a
    for nm, a in state.emitted.items():
        lanes[f"em_{nm}"] = acc(nm, a)
    for nm, a in state.emitted_isnull.items():
        lanes[f"ei_{nm}"] = a
    lanes["ev"] = state.emitted_valid
    return lanes, (table.live, state.emitted_valid)


def mv_lanes(table, state) -> Tuple[dict, torch.Tensor]:
    """Device MV: pk lanes + value lanes + null lanes, live rows."""
    lanes = {f"k{i}": k for i, k in enumerate(table.keys)}
    for nm, a in state.values.items():
        lanes[f"v_{nm}"] = a
    for nm, a in state.vnulls.items():
        lanes[f"n_{nm}"] = a
    return lanes, table.live


def dedup_lanes(table) -> Tuple[dict, torch.Tensor]:
    """Append-only dedup: the seen-set is the state — its key lanes,
    live slots."""
    return {f"k{i}": k for i, k in enumerate(table.keys)}, table.live


def filter_lanes(table, maxes) -> Tuple[dict, torch.Tensor]:
    """DynamicMaxFilter: key lanes + per-key max, live slots."""
    lanes = {f"k{i}": k for i, k in enumerate(table.keys)}
    lanes["max"] = maxes
    return lanes, table.live


def join_side_lanes(side) -> Tuple[dict, torch.Tensor]:
    """One join side: keys + bucket payload rows + degrees, each bucket
    lane masked by ``row_valid`` (stale bytes in vacated entries must
    not move the digest), live key slots."""
    lanes = {f"k{i}": k for i, k in enumerate(side.table.keys)}
    rv = side.row_valid
    for nm, a in side.rows.items():
        lanes[f"r_{nm}"] = Masked(a, rv)
    for nm, a in side.row_nulls.items():
        lanes[f"rn_{nm}"] = Masked(a, rv)
    lanes["rv"] = rv
    lanes["deg"] = Masked(side.degree, rv)
    return lanes, side.table.live


def host_lanes(lanes: dict, live) -> Tuple[dict, np.ndarray]:
    """Torch lanes and mask(s) as numpy, for ``host_digest`` (a
    ``Masked`` lane with its entries applied by ``np.where``)."""
    masks = _masks(live)
    keep = None
    for m in masks:
        m = m.cpu().numpy()
        keep = m if keep is None else keep | m
    out = {}
    for k, v in lanes.items():
        if isinstance(v, Masked):
            a, e = v.lane.cpu().numpy(), v.entries.cpu().numpy()
            e = e.reshape(e.shape + (1,) * (a.ndim - e.ndim))
            out[k] = np.where(e, a, np.zeros((), a.dtype))
        else:
            out[k] = v.cpu().numpy()
    return out, keep
