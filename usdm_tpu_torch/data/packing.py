"""Multipack FFD batch sampler: a g++-built host core and its numpy twin.

Port of usdm_tpu/data/packing.py: first-fit-decreasing packing of
variable-length samples into `batch_max_length`-token bins, one bin per
data-parallel rank per step.  The core is the port's own copy of the FFD
source (`usdm_tpu_torch/native/ffd.cpp`), built with g++ at first use into
`usdm_tpu_torch/_build/ffd-<hash>/libffd.so` (keyed by the source and flags,
as ops/_build.py keys the CUDA library) and loaded with ctypes.  A missing
g++ or a failed build raises with the compiler's output (usdm_tpu drops to
numpy then); the numpy twin runs only when the caller asks for it
(`use_native=False`) and gives the same batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
FFD_SOURCE = PKG_DIR / "native" / "ffd.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the FFD packer of usdm_tpu_torch cannot be "
                           "built (MultipackSampler(use_native=False) runs the numpy twin)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(FFD_SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({r.returncode}) building {FFD_SOURCE}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The FFD library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + FFD_SOURCE.read_bytes())
            path = BUILD_DIR / f"ffd-{h.hexdigest()[:16]}" / "libffd.so"
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.ffd_check.restype = ctypes.c_int
            lib.ffd_check.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.ffd_allocate.restype = ctypes.c_int64
            lib.ffd_allocate.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p]
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# The numpy twin (the same batches)
# ---------------------------------------------------------------------------


def _ffd_check_np(a: np.ndarray, c: int, n_bins: int) -> bool:
    order = np.argsort(-a, kind="stable")
    space = np.full(n_bins, c, dtype=np.int64)
    for i in order:
        fit = np.nonzero(space >= a[i])[0]
        if len(fit) == 0:
            return False
        space[fit[0]] -= a[i]
    return True


def _ffd_pack_np(a: np.ndarray, c: int) -> Tuple[np.ndarray, int]:
    order = np.argsort(-a, kind="stable")
    bins: List[int] = []
    bin_of = np.full(len(a), -1, dtype=np.int64)
    for i in order:
        placed = -1
        for bi, s in enumerate(bins):
            if s >= a[i]:
                bins[bi] = s - a[i]
                placed = bi
                break
        if placed < 0:
            bins.append(c - a[i])
            placed = len(bins) - 1
        bin_of[i] = placed
    return bin_of, len(bins)


def _allocate_np(lengths: np.ndarray, c: int, n_ranks: int, rank: int):
    cumsum = np.concatenate([[0], np.cumsum(lengths)])
    start, consumed = 0, 0
    batches: List[np.ndarray] = []
    total_used = 0
    n = len(lengths)
    while start < n:
        budget = consumed + c * n_ranks
        hi = int(np.searchsorted(cumsum[start:], budget, side="right"))
        hi = min(hi, n - start + 1)
        if hi < 1:
            break
        lo = 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _ffd_check_np(lengths[start : start + mid], c, n_ranks):
                lo = mid
            else:
                hi = mid
        bin_of, used = _ffd_pack_np(lengths[start : start + lo], c)
        if used < n_ranks:
            break
        batches.append(start + np.nonzero(bin_of == rank)[0])
        total_used += int(lengths[start : start + lo].sum())
        start += lo
        consumed = int(cumsum[start])
    return batches, total_used


def _allocate_native(lengths: np.ndarray, c: int, n_ranks: int, rank: int):
    lib = library()
    n = len(lengths)
    arr = np.ascontiguousarray(lengths, np.int64)
    out_idx = np.empty(n, np.int64)
    out_off = np.empty(n + 2, np.int64)
    total_used = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nb = lib.ffd_allocate(arr.ctypes.data_as(i64p), n, c, n_ranks, rank,
                          out_idx.ctypes.data_as(i64p), out_off.ctypes.data_as(i64p), n + 1,
                          ctypes.byref(total_used))
    return [out_idx[out_off[i] : out_off[i + 1]].copy() for i in range(nb)], int(total_used.value)


# ---------------------------------------------------------------------------
# Public sampler
# ---------------------------------------------------------------------------


class MultipackSampler:
    """Length-aware distributed batch sampler: per-epoch lists of dataset
    indices for `rank`, each packing to at most `batch_max_length` tokens."""

    def __init__(
        self,
        batch_max_length: int,
        lengths: np.ndarray,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
        use_native: bool = True,
    ):
        self.c = int(batch_max_length)
        self.lengths = np.asarray(lengths, np.int64)
        if not (self.lengths <= self.c).all():
            raise ValueError("filter samples longer than batch_max_length first")
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.use_native = use_native
        self.eff_total_used = 0
        self.eff_total_slots = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def generate_batches(self, set_stats: bool = False) -> List[np.ndarray]:
        perm = np.random.default_rng(self.seed + self.epoch).permutation(len(self.lengths))
        allocate = _allocate_native if self.use_native else _allocate_np
        batches, used = allocate(self.lengths[perm], self.c, self.num_replicas, self.rank)
        if set_stats:
            self.eff_total_used += used
            self.eff_total_slots += len(batches) * self.c * self.num_replicas
        return [perm[b] for b in batches]

    def __iter__(self):
        return iter(self.generate_batches(set_stats=True))

    def num_batches(self) -> int:
        return len(self.generate_batches())

    def efficiency(self) -> float:
        return self.eff_total_used / max(self.eff_total_slots, 1)
