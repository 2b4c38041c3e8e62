"""Build and load the hand-written Hopper kernels in `csrc/`.

Every `csrc/*.cu` is compiled by its own nvcc process, all started together,
and the objects are linked into ONE shared library with a plain C interface
(no PyTorch headers, so the build takes seconds), loaded with ctypes.  The
build runs at first use, into `_build/<hash>/` keyed by the sources and
flags, so a fresh checkout builds everything on its first call.
A missing nvcc or a failed compile raises with the compiler's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libusdm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh: the floating types kernels compute
# in, and int8 for quantized operands
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8_CODE = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_kernels: dict = {}  # entry point name -> typed ctypes function
build_log = ""  # nvcc's output of the build this process did (ptxas stats)
build_seconds = 0.0  # wall time of that build (0 when loaded from _build/)


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of usdm_tpu_torch cannot be built")
    return nvcc


def _sources() -> Sequence[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with the output of the first that
    fails, else return their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(out: Path) -> None:
    global build_log, build_seconds
    nvcc = _find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out.with_suffix(f".{tag}")
    t0 = time.perf_counter()
    try:
        build_log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC_DIR), "-o", str(obj),
                               str(src)] for src, obj in zip(srcs, objs)])
        build_log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                *map(str, objs)]])
    finally:
        build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = BUILD_DIR / _digest() / LIB_NAME
            if not path.exists():
                _compile(path)
            _lib = ctypes.CDLL(str(path))
        return _lib


def kernel(name: str, argtypes: Sequence[type]):
    """C entry point `name` with explicit ctypes signature (pointers and the
    stream are c_void_p; ints c_int/c_longlong; returns cudaError_t), typed
    on its first use and cached by name: each entry point has one signature."""
    fn = _kernels.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _kernels[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    """The handle of `device`'s current stream (the raw pointer, without
    building a torch.cuda.Stream object on every launch)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All kernel operands must sit on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
