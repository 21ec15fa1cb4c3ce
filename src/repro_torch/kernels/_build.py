"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``libraven_kernels.so``, loaded with
``ctypes``. Each source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects. The build happens at first
use, from the sources in the checkout only, into ``build/repro_torch_kernels/``
at the repository root; the library's file name carries a hash of the
sources, so an edited kernel is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
package on machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES: dict[str, list] = {
    # num, cat, offset, scale, cat_values, val_col, out, N, Kn, Kc, Vtot, stream
    "raven_featurize": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    # x, A, B, C, D, V, out, base, N, Fx, T, F, I, L, FC, stream
    "raven_tree_gemm": [
        _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _L, _I, _I, _I, _I, _I, _I, _P,
    ],
    # fk, skeys, spay, out, hit, N, M, P, stream
    "raven_gather_join": [_P, _P, _P, _P, _P, _L, _L, _I, _P],
    # vals, w, sid, partials, counts, sums, mins, maxs, N, C, S, blocks, stream
    "raven_segment_agg": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Launches of each kernel in this process: its wrapper adds one where it
# launches the kernel, and nowhere else. A caller that wants the launches of
# one run sets the counts to 0 before it.
LAUNCHES: dict[str, int] = dict.fromkeys(
    ("featurize", "tree_gemm", "gather_join", "segment_agg"), 0
)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "source at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile every kernel source (in parallel) and link the library;
    returns its path. A library already built from the same sources is
    reused."""
    lib_path = BUILD_DIR / f"libraven_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(exist_ok=True)
    cus = [p for p in _sources() if p.suffix == ".cu"]
    procs = []
    for src in cus:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp_lib = work / lib_path.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.raven_error_string.argtypes = [ctypes.c_int]
            handle.raven_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        text = lib().raven_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")


def require(t, name: str, dtype: torch.dtype, ndim: int, device) -> None:
    """Validate one kernel operand before its pointer crosses into C."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer for C."""
    return torch.cuda.current_stream(device).cuda_stream
