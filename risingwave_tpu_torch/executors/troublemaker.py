"""TroublemakerExecutor — deliberate stream corruption for chaos tests.

Port of ``risingwave_tpu/executors/troublemaker.py``. Reference:
src/stream/src/executor/troublemaker.rs:28 — an executor
inserted into test graphs that randomly corrupts the message stream
("insane mode"), proving the surrounding sanity machinery (update
checks, consistency latches, differential stores) actually catches
inconsistencies rather than silently absorbing them.

Seeded + host-side (corruption is a TEST construct; no device work;
``random.Random(seed)`` as in the reference, so one seed injects the
same faults in both packages):
each chunk may have a value lane perturbed, an op flipped, or a row
duplicated. The `log` records every injected fault so a test can
assert detection maps 1:1 to injection.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.executors.base import Executor
from risingwave_tpu_torch.types import Op


class TroublemakerExecutor(Executor):
    def __init__(
        self,
        seed: int = 0,
        rate: float = 0.5,
        modes: Tuple[str, ...] = ("corrupt_value", "flip_op", "dup_row"),
    ):
        self.rng = random.Random(seed)
        self.rate = rate
        self.modes = tuple(modes)
        self.log: List[Tuple[str, str, int]] = []  # (mode, column, row)

    def apply(self, chunk: StreamChunk) -> List[StreamChunk]:
        if self.rng.random() >= self.rate:
            return [chunk]
        data = chunk.to_numpy(with_ops=True)
        ops = np.asarray(data.pop("__op__"), np.int32).copy()
        n = len(ops)
        if n == 0:
            return [chunk]
        cols = {
            k: np.asarray(v).copy()
            for k, v in data.items()
            if not k.endswith("__null")
        }
        nulls = {
            k[: -len("__null")]: np.asarray(v, bool)
            for k, v in data.items()
            if k.endswith("__null")
        }
        mode = self.rng.choice(self.modes)
        row = self.rng.randrange(n)
        if mode == "corrupt_value":
            name = self.rng.choice(sorted(cols))
            arr = cols[name]
            if name in nulls and nulls[name][row]:
                # corrupting a NULL cell would be masked downstream:
                # resurrect it instead (a visible corruption)
                nulls[name][row] = False
                arr[row] = self.rng.randint(1, 1 << 20)
            elif arr.dtype == np.bool_:
                arr[row] = not bool(arr[row])
            elif np.issubdtype(arr.dtype, np.integer):
                arr[row] = arr[row] + self.rng.randint(1, 1 << 20)
            elif np.isnan(float(arr[row])):
                arr[row] = 12345.5  # NaN + x stays NaN: set a value
            else:
                arr[row] = arr[row] + 1.5
            self.log.append((mode, name, row))
        elif mode == "flip_op":
            ops[row] = (
                int(Op.DELETE)
                if ops[row] == Op.INSERT
                else int(Op.INSERT)
            )
            self.log.append((mode, "__op__", row))
        else:  # dup_row
            for k in cols:
                cols[k] = np.concatenate([cols[k], cols[k][row : row + 1]])
            for k in nulls:
                nulls[k] = np.concatenate(
                    [nulls[k], nulls[k][row : row + 1]]
                )
            ops = np.concatenate([ops, ops[row : row + 1]])
            self.log.append((mode, "*", row))
        cap = max(chunk.capacity, 1 << (len(ops) - 1).bit_length())
        return [
            StreamChunk.from_numpy(
                cols, cap, ops=ops, nulls=nulls or None, device=chunk.device
            )
        ]
