"""Builds and loads the port's CUDA kernels (``dots_ocr_tpu_torch/csrc``).

All ``*.cu`` sources compile with ``nvcc`` (one process per source, run in
parallel) and link into ONE shared library with a plain C interface,
loaded through ``ctypes`` (no PyTorch headers: a build takes seconds
instead of minutes). The library is cached under
``csrc/build/`` keyed by a hash of the sources, and built at first use,
never at import: the CPU tests import every module on hosts without a CUDA
toolkit; concurrent processes build it once, under a file lock. :func:`set_build_dir` moves the cache (the server's
``--compile-cache``): a process that finds the library there loads it
without running ``nvcc``.

Every entry point takes ``ctypes.c_void_p`` for pointers and the stream,
launches on the given stream without synchronising, and returns
``cudaGetLastError()`` so a refused launch raises in the wrapper.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    # q, k_pool, v_pool, k_scale, v_scale, lengths, page_indices, part_o,
    # part_ml (scratch), out, then as the bf16 mode
    "dots_paged_attention_int8": [_P] * 10 + [_I] * 10 + [_F, _P],
    # x, packed, scales, part (scratch), out, M, K, N, units_per_split,
    # n_split, stream
    "dots_int4_matmul_w4a16": [_P] * 5 + [_I] * 5 + [_P],
    # x, packed, scales, scratch (xq, then the row scales), out, M, K, N,
    # cols (0: the wgmma kernel), cluster, stream
    "dots_int4_matmul_w4a8": [_P] * 5 + [_I] * 5 + [_P],
    # q, k, v, segment_ids, out, nw, W, H, D, sm_scale, stream
    "dots_window_attention_bf16": [_P] * 5 + [_I] * 4 + [_F, _P],
    # q, k_all, v_all, lengths, page_indices, part_o, part_ml (scratch), out,
    # B, H, KV, D, n_slots, page_size, max_pages, layer, chunk, n_split,
    # sm_scale, stream
    "dots_paged_attention_v1_bf16": [_P] * 8 + [_I] * 10 + [_F, _P],
    # q, k_all, v_all, k_scales_all, v_scales_all, lengths, page_indices,
    # part_o, part_ml, out, then as the bf16 mode
    "dots_paged_attention_v1_int8": [_P] * 10 + [_I] * 10 + [_F, _P],
    # x, q, scale, bias (or null), out, M, K, N, nk, out_f32, bias_bf16,
    # rows_tile, consumers, split, cluster, stream
    "dots_w8a16_matmul": [_P] * 5 + [_I] * 10 + [_P],
    # logits, temps (or null), keys, key_step, positions (or null), tag,
    # flat, noise_out (or null), out, B, V, cluster, stream
    "dots_threefry_gumbel_argmax": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P],
    # operands (16 int64 on the host), out, rows, cols, iota, mode, minval,
    # stream
    "dots_threefry2x32": [_P, _P] + [_I] * 4 + [_F, _P],
    # q, pool, lengths, page_tables, part_o, part_ml (scratch), out, S, H,
    # rank, rope, page_size, max_pages, chunk, n_split, sm_scale, stream
    "dots_mla_latent_decode_bf16": [_P] * 7 + [_I] * 8 + [_F, _P],
}

_LIB: Optional[ctypes.CDLL] = None
lib_path: Optional[str] = None  # the loaded library's file
built = False  # whether this process ran nvcc
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


def _so_name() -> str:
    """The library's file name: a hash of the sources and the flags."""
    digest = hashlib.sha256()
    for path in (sorted(glob.glob(os.path.join(CSRC, "*.cu")))
                 + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"dots_kernels_{digest.hexdigest()[:16]}.so"


def set_build_dir(path: str) -> None:
    """Build into and load from ``path`` from now on. A library this
    process has loaded already is copied there, so that the next process
    finds it."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path)
    target = os.path.join(BUILD_DIR, _so_name())
    if lib_path is not None and not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        shutil.copyfile(lib_path, tmp)
        os.replace(tmp, target)


def _build() -> str:
    """The library's path, built first if it is not there. Processes that
    build take ``BUILD_DIR/.lock`` in turn (the ranks of a TP server share one
    directory), so a process that waited finds the library its
    predecessor built and runs no ``nvcc``."""
    so_path = os.path.join(BUILD_DIR, _so_name())
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so_path):
                return so_path
            return _compile(so_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(so_path: str) -> str:
    global build_log, built
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    built = True
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
    global _LIB, lib_path
    if _LIB is None:
        path = _build()
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB, lib_path = lib, path
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
