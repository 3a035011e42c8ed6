"""The reference's dtype promotion, weak types included.

The JAX package runs with x64 on and evaluates expressions with
``jax.numpy``, whose binary operations promote along JAX's type lattice
(``jax._src.dtypes``): a Python int or float literal is *weakly* typed
(``jnp.full(n, 5)`` is a weak int64 lane), and a weak operand takes the
other operand's type where the lattice allows it. So ``int32_col + 5``
is int32, ``int32_col * 0.5`` a weak float64, ``float32_col * 0.5``
float32, and ``int64_col + float32_col`` float32. torch promotes
otherwise, so the port computes every result type here and casts its
operands explicitly.

A typed value is a ``(dtype, weak)`` pair of a torch dtype and a bool.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# JAX's promotion lattice without the complex and wide unsigned types;
# "i*" and "f*" are the weak int and weak float nodes
_LATTICE = {
    "b1": ("i*",),
    "i*": ("u8", "i8"),
    "u8": ("i16",),
    "i8": ("i16",),
    "i16": ("i32",),
    "i32": ("i64",),
    "i64": ("f*",),
    "f*": ("f16", "bf16"),
    "f16": ("f32",),
    "bf16": ("f32",),
    "f32": ("f64",),
    "f64": (),
}
_NODE = {
    torch.bool: "b1", torch.uint8: "u8", torch.int8: "i8", torch.int16: "i16",
    torch.int32: "i32", torch.int64: "i64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64",
}
_DTYPE = {v: k for k, v in _NODE.items()}
_DTYPE["i*"] = torch.int64
_DTYPE["f*"] = torch.float64

Typed = Tuple[torch.dtype, bool]


@lru_cache(maxsize=None)
def _upper(node: str) -> frozenset:
    out = {node}
    for n in _LATTICE[node]:
        out |= _upper(n)
    return frozenset(out)


def _node(dtype: torch.dtype, weak: bool) -> str:
    node = _NODE.get(dtype)
    if node is None:
        raise TypeError(f"expressions do not take dtype {dtype}")
    if weak and node != "b1":
        return "f*" if dtype.is_floating_point else "i*"
    return node


@lru_cache(maxsize=None)
def _join(a: str, b: str) -> str:
    common = _upper(a) & _upper(b)
    for n in common:
        if _upper(n) == common:
            return n
    raise TypeError(f"no promotion of {a} and {b}")


def result_type(*typed: Typed) -> Typed:
    """``jnp.result_type`` of typed values: the lattice join, weak when
    the join is a weak node."""
    node = _node(*typed[0])
    for t in typed[1:]:
        node = _join(node, _node(*t))
    return _DTYPE[node], node in ("i*", "f*")


def to_inexact(t: Typed) -> Typed:
    """``promote_args_inexact``: bool and the narrow ints become float32,
    int64 float64 (``jax._src.dtypes.to_inexact_dtype``)."""
    dtype, weak = t
    if dtype.is_floating_point:
        return t
    return (torch.float64 if dtype == torch.int64 else torch.float32), weak


def to_numeric(t: Typed) -> Typed:
    """``promote_args_numeric``: bool becomes int32."""
    return (torch.int32, False) if t[0] == torch.bool else t


def literal_type(value) -> Typed:
    """The typed lane ``jnp.full(n, value)`` makes: a Python int or float
    is weak int64 / float64, a bool strong bool, a numpy scalar strong
    in its own dtype."""
    if isinstance(value, (bool, np.bool_)):
        return torch.bool, False
    if isinstance(value, np.generic):
        return torch_dtype(value.dtype), False
    if isinstance(value, int):
        return torch.int64, True
    if isinstance(value, float):
        return torch.float64, True
    raise TypeError(f"unsupported literal {value!r}")


_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or scalar-type dtype spec."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (TypeError, KeyError):
        raise TypeError(f"unsupported dtype {dtype!r}") from None
