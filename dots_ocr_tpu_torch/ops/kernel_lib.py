"""Builds and loads the port's CUDA kernels (``dots_ocr_tpu_torch/csrc``).

All ``*.cu`` sources compile with ``nvcc`` (one process per source, run in
parallel) and link into ONE shared library with a plain C interface,
loaded through ``ctypes`` (no PyTorch headers: a build takes seconds
instead of minutes). The library is cached under
``csrc/build/`` keyed by a hash of the sources, and built at first use,
never at import: the CPU tests import every module on hosts without a CUDA
toolkit.

Every entry point takes ``ctypes.c_void_p`` for pointers and the stream,
launches on the given stream without synchronising, and returns
``cudaGetLastError()`` so a refused launch raises in the wrapper.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, q_seg, kv_seg, tile_info (scratch), out, B, Tq, S, H, KV, D,
    # causal, q_offset, sm_scale, stream
    "dots_flash_attention_bf16": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k_pool, v_pool, lengths, page_indices, part_o, part_ml (scratch),
    # out, B, nq, H, KV, D, num_pages, page_size, max_pages, chunk, n_split,
    # sm_scale, stream
    "dots_paged_attention_bf16": [_P] * 8 + [_I] * 10 + [_F, _P],
    # q, k_pool, v_pool, k_scale, v_scale, lengths, page_indices, out, B,
    # nq, H, KV, D, num_pages, page_size, max_pages, sm_scale, stream
    "dots_paged_attention_int8": [_P] * 8 + [_I] * 8 + [_F, _P],
    # x, packed, scales, out, M, K, N, stream
    "dots_int4_matmul_w4a16": [_P] * 4 + [_I] * 3 + [_P],
    # x, packed, scales, xq (scratch), a_scale (scratch), out, M, K, N, stream
    "dots_int4_matmul_w4a8": [_P] * 6 + [_I] * 3 + [_P],
    # q, k, v, segment_ids, out, nw, W, H, D, sm_scale, stream
    "dots_window_attention_bf16": [_P] * 5 + [_I] * 4 + [_F, _P],
    # q, k_all, v_all, lengths, page_indices, out, B, H, KV, D, n_slots,
    # page_size, max_pages, layer, sm_scale, stream
    "dots_paged_attention_v1_bf16": [_P] * 6 + [_I] * 8 + [_F, _P],
    # q, k_all, v_all, k_scales_all, v_scales_all, lengths, page_indices,
    # out, then as the bf16 mode
    "dots_paged_attention_v1_int8": [_P] * 8 + [_I] * 8 + [_F, _P],
}

_LIB: Optional[ctypes.CDLL] = None
build_log: str = ""  # nvcc's output (with -Xptxas -v: registers, spills)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _build() -> str:
    global build_log
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256()
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, f"dots_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for src, obj in zip(sources, objects)]
    build_log = "".join(proc.communicate(timeout=600)[0] for proc in procs)
    failed = [src for src, proc in zip(sources, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True, timeout=600)
        build_log += link.stdout + link.stderr
        failed = ["link"] if link.returncode != 0 else []
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, so_path)  # atomic: concurrent builders never see half a file
    return so_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (cached per process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
