"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
the 700 W power limit; the run records the card's own limit beside every
share)."""

PEAK_OPS_PER_S = {
    "int8": 1979e12,
    "fp8": 1979e12,
    "bf16": 989e12,
    "tf32": 495e12,
    "3xtf32": 495e12 / 3,  # f32 products as three TF32 products
    "f32": 67e12,  # CUDA cores, outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def least_time(ops: float, n_bytes: float, kind: str) -> float:
    """The least seconds of a piece of work: the larger of its operations
    over the peak of `kind` and its bytes over the memory bandwidth."""
    return max(ops / PEAK_OPS_PER_S[kind], n_bytes / HBM_BYTES_PER_S)
