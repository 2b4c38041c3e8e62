"""Process set-up that must happen before torch is imported, the card
check and the guard against JAX in the measuring process."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json's directory
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout: only a first run builds
FORBIDDEN = ("jax", "jaxlib", "flax", "usdm_tpu")


def prepare_process() -> None:
    """Fixed cache directories inside the checkout, and libraries kept from
    loading JAX on their own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (`usdm_tpu_torch` is not `usdm_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    """Exit without a result unless `n` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"benchmark: needs {n} CUDA card(s), found {have}\n")
        sys.exit(3)
