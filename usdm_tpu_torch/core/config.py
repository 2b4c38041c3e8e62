"""The frozen config dataclasses, shared with usdm_tpu.

The port and the JAX package read one contract: this module re-exports
usdm_tpu/core/config.py, which imports only the standard library.
"""

from usdm_tpu.core.config import (  # noqa: F401
    BigVGANConfig,
    CfmTrainConfig,
    EngineConfig,
    MelConfig,
    MistralConfig,
    TokenSpace,
    VoiceboxConfig,
    XlsrConfig,
)
