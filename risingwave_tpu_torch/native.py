"""The host MV's native row map (C++), loaded with ctypes.

Port of ``risingwave_tpu/native.py``: ``native_src/mv_map.cpp`` (the
port's own copy) is compiled with ``g++`` on first use into the
git-ignored ``_build/`` beside the CUDA libraries, named after a hash of
the source, so an edited source is rebuilt and a stale library never
loads. Without a toolchain ``get_lib`` returns None and the host MV
keeps its Python dict backend, as the reference does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native_src", "mv_map.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:12]
        so = os.path.join(_BUILD_DIR, f"librw_native_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
            # only after the new build landed: drop older versions' builds
            for old in glob.glob(os.path.join(_BUILD_DIR, "librw_native_*.so")):
                if old != so:
                    try:
                        os.remove(old)
                    except OSError:
                        pass
        lib = ctypes.CDLL(so)
        lib.mv_new.restype = ctypes.c_void_p
        lib.mv_new.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.mv_free.argtypes = [ctypes.c_void_p]
        lib.mv_apply.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64]
        lib.mv_len.restype = ctypes.c_int64
        lib.mv_len.argtypes = [ctypes.c_void_p]
        lib.mv_dump.argtypes = [ctypes.c_void_p] * 3
        lib.mv_get.restype = ctypes.c_int32
        lib.mv_get.argtypes = [ctypes.c_void_p] * 3
        return lib
    except (OSError, subprocess.CalledProcessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


class NativeMvMap:
    """An int64-lane MV row map backed by the C++ unordered_map."""

    def __init__(self, k_arity: int, v_arity: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.k_arity = k_arity
        self.v_arity = v_arity
        self._h = self._lib.mv_new(k_arity, v_arity)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.mv_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.mv_len(self._h))

    def apply(self, keys: np.ndarray, vals: np.ndarray, is_del: np.ndarray) -> None:
        """Rows in order: ``is_del[i]`` erases the key, else upserts it."""
        n = len(is_del)
        if n == 0:
            return
        keys = np.ascontiguousarray(keys, np.int64).reshape(n, self.k_arity)
        vals = (np.ascontiguousarray(vals, np.int64).reshape(n, self.v_arity)
                if self.v_arity else np.zeros((n, 0), np.int64))
        is_del = np.ascontiguousarray(is_del, np.uint8)
        self._lib.mv_apply(self._h, keys.ctypes.data, vals.ctypes.data, is_del.ctypes.data, n)

    def dump(self):
        n = len(self)
        keys = np.empty((n, self.k_arity), np.int64)
        vals = np.empty((n, self.v_arity), np.int64)
        if n:
            self._lib.mv_dump(self._h, keys.ctypes.data, vals.ctypes.data)
        return keys, vals

    def get(self, key) -> Optional[tuple]:
        k = np.asarray(key, np.int64)
        out = np.empty(self.v_arity, np.int64)
        if self._lib.mv_get(self._h, k.ctypes.data, out.ctypes.data):
            return tuple(out.tolist())
        return None
