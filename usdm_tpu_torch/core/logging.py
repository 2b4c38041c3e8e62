"""Metrics logging, shared with usdm_tpu.

Re-exports usdm_tpu/core/logging.py's MetricsLogger (a JSONL metrics
stream), which imports no JAX.
"""

from usdm_tpu.core.logging import MetricsLogger  # noqa: F401
