"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Builds happen at first use,
into `streamvln_tpu_torch/_build/` (listed in .gitignore); a library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded. `build_all()` starts one
`nvcc` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
KERNELS = ("vit_attention", "flash_attention", "flash_attention_bwd",
           "int4_matmul", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    "svt_vit_attention": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L,
                          _I, _I, _I, _I, _F, _P],
    "svt_flash_attention": [_P, _P, _P, _P, _P, _P] + [_L] * 12
    + [_I] * 6 + [_F, _F, _P],
    "svt_flash_attention_lse": [_P] * 7 + [_L] * 12 + [_I] * 6 + [_F, _P],
    # q, k, v, dO, lse, dsum, dQ | q_pos, k_pos, 21 strides (an array)
    "svt_flash_bwd_dq": [_P] * 10 + [_I] * 6 + [_F, _P],
    # q, k, v, dO, lse, dsum, dK, dV | q_pos, k_pos, 21 strides
    "svt_flash_bwd_dkv": [_P] * 11 + [_I] * 6 + [_F, _P],
    # x, w, scales, out | M, din, dout, is_bf16
    "svt_int4_matmul": [_P] * 4 + [_I] * 4 + [_P],
    # w, scales, out | half, dout, is_bf16
    "svt_int4_dequant_split": [_P] * 3 + [_I] * 3 + [_P],
    # q, k, v, lengths, out, 8 strides (an array) | B, Hq, Hkv, Smax, D,
    # scale, is_bf16
    "svt_decode_attention": [_P] * 6 + [_I] * 5 + [_F, _I, _P],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all `nvcc`
    processes at once. Returns {name: library path}; raises with the
    compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc rc {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            for sym, argtypes in ARGTYPES.items():
                if hasattr(lib, sym):
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
