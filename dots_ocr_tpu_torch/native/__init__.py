"""Native (C++) im2col for the vision patcher, compiled on demand and loaded
via ctypes.

``get_lib()`` compiles ``patchify.cc`` with the host compiler on first use
into ``native/build/`` (gitignored; the file name carries a hash of the
source) and returns the ctypes handle, or None when no compiler is
available: ``patchify_native`` then returns None and the caller runs its
numpy im2col, which computes the same array.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "patchify.cc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"patchify_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    for compiler in ("c++", "g++", "clang++"):
        try:
            subprocess.run(
                [compiler, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so_path)  # atomic: concurrent builders never see half a file
            return so_path
        except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
            logger.debug("compiler %s failed: %s", compiler, e)
            continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Compiled library handle, or None (fall back to numpy)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DOTS_OCR_DISABLE_NATIVE"):
        return None
    try:
        so_path = _build()
        if so_path is None:
            return None
        lib = ctypes.CDLL(so_path)
        lib.patchify.restype = ctypes.c_long
        lib.patchify.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _LIB = lib
    except Exception:  # noqa: BLE001
        logger.exception("native library unavailable; using the numpy im2col")
        _LIB = None
    return _LIB


def patchify_native(
    arr: "np.ndarray", perm: "np.ndarray", patch: int, grid_w: int
) -> "Optional[np.ndarray]":
    """Single-pass im2col + emission reorder (C++). arr: [H, W, C] uint8
    contiguous; perm: [n_tokens] int32 (-1 = zero pad slot). Returns
    [n_tokens, patch*patch*C] uint8, or None (use the numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
        return None
    h, w, c = arr.shape
    perm = np.ascontiguousarray(perm, np.int32)
    out = np.empty((len(perm), patch * patch * c), np.uint8)
    rc = lib.patchify(
        arr.ctypes.data_as(ctypes.c_void_p), h, w, c, patch,
        perm.ctypes.data_as(ctypes.c_void_p), len(perm), grid_w,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out
