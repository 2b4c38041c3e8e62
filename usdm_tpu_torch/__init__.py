"""usdm_tpu_torch: the PyTorch/CUDA port of usdm_tpu for NVIDIA Hopper.

The JAX package `usdm_tpu` stays the reference this port is held against.
The port imports torch and never jax, and nothing of `usdm_tpu`: it keeps
its own copies of the config dataclasses (`core/config.py`), the metrics
logger (`core/logging.py`) and the wav IO (`audio/wav.py`).  Kernels that
usdm_tpu wrote in Pallas are CUDA C++ sources in `csrc/`, built with nvcc
at first use (`ops/_build.py`).  Entry points run on the card (`cuda`)
unless the caller asks for the CPU.
"""
