"""Native (C++) routines of the host pipeline, compiled on demand and loaded
via ctypes: the PDF filters of ``ingest/minipdf.py`` (PNG/TIFF predictors,
RunLength, LZW, RC4), the JBIG2 generic-region and symbol-dictionary
decoders of ``ingest/jbig2.py``, and the vision patcher's im2col
(``models/preprocess.py``).

``get_lib()`` compiles ``minipdf_accel.cc`` (the port's copy of the JAX
package's native source) with the host compiler on first use into
``native/build/`` (gitignored; the file name carries a hash of the source)
and returns the ctypes handle, or None when no compiler is available: each
``*_native`` function then returns None and its caller runs the Python or
numpy path, which computes the same bytes.
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

_SRC = os.path.join(os.path.dirname(__file__), "minipdf_accel.cc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"minipdf_accel_{digest}.so")
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
    """Compiled library handle, or None (fall back to Python)."""
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
        lib.png_unpredict.restype = ctypes.c_long
        lib.png_unpredict.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.runlength_decode.restype = ctypes.c_long
        lib.runlength_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.patchify.restype = ctypes.c_long
        lib.patchify.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.lzw_decode.restype = ctypes.c_long
        lib.lzw_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.rc4.restype = None
        lib.rc4.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_void_p,
        ]
        lib.jbig2_generic.restype = ctypes.c_int
        lib.jbig2_generic.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.jbig2_symbol_dict.restype = ctypes.c_int
        lib.jbig2_symbol_dict.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
    except Exception:  # noqa: BLE001
        logger.exception("native library unavailable; using Python fallbacks")
        _LIB = None
    return _LIB


def png_unpredict_native(
    data: bytes, predictor: int, columns: int, colors: int, bpc: int
) -> Optional[bytes]:
    """Native PNG/TIFF predictor reconstruction; None = use Python path."""
    lib = get_lib()
    if lib is None:
        return None
    row_len = (columns * colors * bpc + 7) // 8
    n_rows = len(data) // (row_len + 1) + 2 if predictor >= 10 else 1
    cap = max(len(data), n_rows * row_len) + row_len
    out = np.empty(cap, np.uint8)
    written = lib.png_unpredict(
        data, len(data), predictor, columns, colors, bpc,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def runlength_decode_native(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) * 130 + 16  # worst case: every byte expands to 128
    out = np.empty(cap, np.uint8)
    written = lib.runlength_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def lzw_decode_native(data: bytes, early: int) -> Optional[bytes]:
    """Native LZW decode; None = use the Python path, retries capacity."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(4096, len(data) * 8)
    for _ in range(6):  # pathological expansion: grow and retry
        out = np.empty(cap, np.uint8)
        written = lib.lzw_decode(
            data, len(data), early, out.ctypes.data_as(ctypes.c_void_p), cap
        )
        if written == -1:
            cap *= 8
            continue
        if written < 0:
            return None
        return out[:written].tobytes()
    return None


def rc4_native(key: bytes, data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None or not key:
        return None
    out = np.empty(len(data), np.uint8)
    lib.rc4(key, len(key), data, len(data),
            out.ctypes.data_as(ctypes.c_void_p))
    return out.tobytes()


def jbig2_generic_native(
    data: bytes,
    width: int,
    height: int,
    pixels: "list[tuple[int, int]]",
    tpgdon: bool,
    sltp_cx: int,
) -> "Optional[np.ndarray]":
    """Native arithmetic JBIG2 generic-region decode (full MQ coder in
    C++). Returns bool[height, width], or None (use the Python path)."""
    lib = get_lib()
    if lib is None or not (0 < len(pixels) <= 16):
        return None
    dx = np.array([p[0] for p in pixels], np.int8)
    dy = np.array([p[1] for p in pixels], np.int8)
    out = np.empty((height, width), np.uint8)
    rc = lib.jbig2_generic(
        data, len(data), width, height, len(pixels),
        dx.ctypes.data_as(ctypes.c_void_p), dy.ctypes.data_as(ctypes.c_void_p),
        int(tpgdon), sltp_cx, out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out.astype(bool)


def jbig2_symbol_dict_native(
    data: bytes,
    pixels: "list[tuple[int, int]]",
    num_new: int,
    num_input: int,
    max_pixels: int = 32_000_000,
) -> "Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]":
    """Native JBIG2 symbol-dictionary decode (whole dictionary in one
    call). Returns (dims[num_new, 2] as (h, w), packed row-major bits,
    export flags[num_input+num_new] bool), or None (use Python path)."""
    lib = get_lib()
    if lib is None or not (0 < len(pixels) <= 16):
        return None
    dx = np.array([p[0] for p in pixels], np.int8)
    dy = np.array([p[1] for p in pixels], np.int8)
    dims = np.zeros(max(num_new, 1) * 2, np.int32)
    bits = np.empty(max_pixels, np.uint8)
    export = np.zeros(num_input + num_new + 1, np.uint8)
    rc = lib.jbig2_symbol_dict(
        data, len(data), len(pixels),
        dx.ctypes.data_as(ctypes.c_void_p), dy.ctypes.data_as(ctypes.c_void_p),
        num_new, num_input, max_pixels,
        dims.ctypes.data_as(ctypes.c_void_p),
        bits.ctypes.data_as(ctypes.c_void_p),
        export.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return (
        dims.reshape(-1, 2),
        bits,
        export[: num_input + num_new].astype(bool),
    )


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
