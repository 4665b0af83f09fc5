"""Build and load the port's CUDA kernels (``funasr_tpu_torch/csrc/*.cu``).

At first use every source is compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all in parallel) and linked into one shared library with a plain C interface
under ``build/funasr_tpu_torch/`` at the repository root, and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds. The sources share
``csrc/hopper.cuh`` (TMA, mbarriers, wgmma); the TMA tensor maps are encoded with the
driver's ``cuTensorMapEncodeTiled``, looked up in ``libcuda.so.1`` with ``dlsym`` (hence
``-ldl``; no ``-lcuda``). The library's name carries a hash of the sources, headers and
flags, so an edited kernel is rebuilt and a stale one never loaded. Nothing here runs at
import: the CPU tests import the wrappers on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "funasr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_LINK_FLAGS = ["-shared", "-ldl"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns a cudaError_t as int)
_SIGNATURES = {
    # dtype, q, k, v, o, lengths, B, H, Tq, Tk, D, strides[12], sm_scale, mode, vad_pos,
    # block_rows, stream
    "flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.POINTER(_L), ctypes.c_float, _I, _P, _I, _P],
    # dtype, x, w, mask, out, B, T, C, K, left, x_sb, x_st, stream
    "fsmn_memory_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _P],
    "fsmn_memory_generic_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _P],
    # dtype, x, x_row_stride, w_q, scale, bias, bias_dtype, x_q, sx, out, out_pitch, M, N,
    # K, Kp, sms, stream
    "w8a8_linear_fwd": [_I, _P, _L, _P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds):
    """Run the commands concurrently; (return code, output) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(p.returncode, out) for p, out in ((p, p.communicate()[0]) for p in procs)]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library: one nvcc per source, all started
    together, then one link. The returned handle has ``build_seconds`` (0.0 when a
    built library was reused) and ``build_log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib_path = BUILD_DIR / f"libfunasr_tpu_torch_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            t0 = time.perf_counter()
            objs = [os.path.join(tmp_dir, src.stem + ".o") for src in sources]
            runs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                             for src, obj in zip(sources, objs)])
            tmp = os.path.join(tmp_dir, lib_path.name)
            if all(rc == 0 for rc, _ in runs):
                runs += _run_all([[_nvcc(), *NVCC_LINK_FLAGS, "-o", tmp, *objs]])
            build_seconds = time.perf_counter() - t0
            log = "".join(out for _, out in runs)
            if any(rc != 0 for rc, _ in runs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            os.replace(tmp, lib_path)  # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_seconds = build_seconds
    lib.build_log = log
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (e.g. a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``: kernels launch there and never sync."""
    return torch.cuda.current_stream(device).cuda_stream
