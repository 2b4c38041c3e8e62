"""usdm_tpu_torch: the PyTorch/CUDA port of usdm_tpu for NVIDIA Hopper.

The JAX package `usdm_tpu` stays the reference this port is held against.
The port imports torch and never jax; of the old package it reuses only
the three JAX-free modules `usdm_tpu.core.config` (the frozen config
dataclasses), `usdm_tpu.core.logging` (the JSONL metrics logger) and
`usdm_tpu.audio.wav` (numpy/scipy wav IO), re-exported as
`usdm_tpu_torch.core.config`, `usdm_tpu_torch.core.logging` and
`usdm_tpu_torch.audio.wav`.  Kernels that
usdm_tpu wrote in Pallas are CUDA C++ sources in `csrc/`, built with nvcc
at first use (`ops/_build.py`).
"""
