"""Arrow interop — StreamChunk <-> pyarrow RecordBatch.

Port of ``risingwave_tpu/array/arrow.py``; ``pyarrow`` is imported
inside each function, as there, so the package imports without it.

Reference: src/common/src/array/arrow/ (arrow conversions used by the
UDF boundary, iceberg/deltalake sinks, and connector parsers).

The device plane stays fixed-width lanes; Arrow is the HOST edge
format: converting OUT compacts live rows and decodes VARCHAR
dictionary codes to proper utf8 (or arrow dictionary arrays);
converting IN pads to chunk capacity and encodes strings through a
``StringDictionary``. NULL lanes map to arrow validity bitmaps both
ways.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.dictionary import StringDictionary
from risingwave_tpu_torch.types import Op


def chunk_to_arrow(
    chunk: StreamChunk,
    dictionaries: Optional[Dict[str, StringDictionary]] = None,
    with_ops: bool = False,
):
    """Live rows -> pyarrow.RecordBatch; ``dictionaries`` maps VARCHAR
    column names to their code dictionaries (decoded to utf8)."""
    import pyarrow as pa

    data = chunk.to_numpy(with_ops=with_ops)
    names = [
        n
        for n in data
        if not n.endswith("__null") and n != "__op__"
    ]
    arrays, fields = [], []
    for n in names:
        col = data[n]
        mask = data.get(n + "__null")
        d = (dictionaries or {}).get(n)
        if d is not None:
            vals = d.decode(col.astype(np.int32))
            arr = pa.array(
                [None if mask is not None and mask[i] else vals[i]
                 for i in range(len(vals))],
                type=pa.string(),
            )
        else:
            arr = pa.array(col, mask=mask)
        arrays.append(arr)
        fields.append(pa.field(n, arr.type, nullable=mask is not None))
    if with_ops:
        arrays.append(pa.array(data["__op__"].astype(np.int8)))
        fields.append(pa.field("__op__", pa.int8(), nullable=False))
    return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))


def chunk_from_arrow(
    batch,
    capacity: Optional[int] = None,
    dictionaries: Optional[Dict[str, StringDictionary]] = None,
    device="cuda",
) -> StreamChunk:
    """pyarrow.RecordBatch -> StreamChunk on ``device``; string columns
    encode through the provided (or fresh) dictionaries, ``__op__``
    becomes the op lane."""
    import pyarrow as pa

    if dictionaries is None:
        dictionaries = {}
    n = batch.num_rows
    cap = capacity or max(2, 1 << max(0, (n - 1)).bit_length())
    cols: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    ops = None
    for name in batch.schema.names:
        arr = batch.column(name)
        if name == "__op__":
            ops = np.asarray(arr.to_numpy(zero_copy_only=False), np.int32)
            continue
        isnull = np.asarray(
            [not v for v in arr.is_valid().to_pylist()], bool
        )
        if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
            d = dictionaries.setdefault(name, StringDictionary())
            py = arr.to_pylist()
            cols[name] = d.encode(
                [("" if v is None else v) for v in py]
            ).astype(np.int32)
        else:
            cols[name] = np.asarray(
                arr.fill_null(0).to_numpy(zero_copy_only=False)
            )
        if isnull.any():
            nulls[name] = isnull
    if ops is None:
        ops_arr = np.full(n, int(Op.INSERT), np.int32)
    else:
        ops_arr = ops
    return StreamChunk.from_numpy(
        cols, cap, ops=ops_arr, nulls=nulls or None, device=device
    )
