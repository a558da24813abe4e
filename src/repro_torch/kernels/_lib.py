"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Every ``csrc/*.cu`` compiles to an object with its own ``nvcc``, all
started together; one more ``nvcc`` links them into one shared library
for ``sm_90a``. The library lands in ``_build/`` beside the package,
keyed by a hash of the sources, so an unchanged tree builds once. Nothing
here runs at import: the first kernel launch calls ``load()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. The decode runs hd (288) threads a CTA; at 72
# registers three CTAs share an SM.
FILE_FLAGS = {"packed_flash_decode.cu": ["-maxrregcount=72"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every exported launcher: each returns a cudaError_t.
SIGNATURES = {
    "sfp_pack_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sfp_quantize_pack_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sfp_unpack_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bitplane_pack_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bitplane_quantize_pack_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _P],
    "bitplane_unpack_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mantissa_quantize_launch": [_P, _P, _P, _L, _I, _P],
    "gecko_pack_launch": [_P, _P, _P, _P, _L, _P],
    "gecko_unpack_launch": [_P, _P, _P, _L, _P],
    "flash_attention_launch": [_P] * 5 + [_I] * 10 + [_F, _F, _P],
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 11 + [_F, _F, _P],
    "packed_flash_decode_launch": [_P] * 11 + [_I] * 16 + [_F, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
ptxas_log: str = ""


class KernelUnavailable(RuntimeError):
    """The CUDA kernel library could not be built or loaded."""


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sum(_sources(), []):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(repr(sorted(FILE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable("nvcc not found: the CUDA kernels build only on "
                            "a machine with the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/`` into ``_build/libsfp_kernels_<hash>.so`` (reused
    when present) and return its path."""
    global build_seconds, ptxas_log
    lib_path = BUILD_DIR / f"libsfp_kernels_{_digest()}.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            objs.append(obj)
            procs.append((cu, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *FILE_FLAGS.get(cu.name, []),
                 "-I", str(CSRC), "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cu, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{out}")
            if proc.returncode != 0:
                failed.append(cu.name)
        ptxas_log = "\n".join(logs)
        if failed:
            raise KernelUnavailable(f"nvcc failed on {failed}:\n{ptxas_log}")
        tmp_lib = Path(tmp) / lib_path.name
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise KernelUnavailable(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelUnavailable(f"cannot load {path}: {e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a raw pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
