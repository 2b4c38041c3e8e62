"""The frozen config dataclasses of the port.

The same fields, defaults, `tiny()` and `replace()` as usdm_tpu's configs,
so a config of one package describes the same model in the other; the port
keeps its own copy and imports nothing of usdm_tpu.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence


class _Base:
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class TokenSpace(_Base):
    """The extended vocabulary of the speech-text LLM: the base Mistral
    vocab (32,000), then `<|continue|>`, `<|correspond|>`,
    `<|unit0|>`..`<|unit9999|>` and `<pad>`: 42,003 ids."""

    base_vocab_size: int = 32000
    num_units: int = 10000
    bos_id: int = 1
    eos_id: int = 2
    space_id: int = 28705  # bare "▁": EOS of the text2unit stage
    newline_id: int = 13

    @property
    def continue_id(self) -> int:
        return self.base_vocab_size

    @property
    def correspond_id(self) -> int:
        return self.base_vocab_size + 1

    @property
    def unit_offset(self) -> int:
        return self.base_vocab_size + 2

    @property
    def pad_id(self) -> int:
        return self.base_vocab_size + 2 + self.num_units

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size + 2 + self.num_units + 1

    def unit_id(self, unit: int) -> int:
        return self.unit_offset + unit


@dataclass(frozen=True)
class MistralConfig(_Base):
    """Mistral-7B-v0.1 geometry with the extended vocabulary."""

    vocab_size: int = 42003
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: int = 4096
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    initializer_range: float = 0.02

    @classmethod
    def tiny(cls, vocab_size: int = 256 + 2 + 32 + 1) -> "MistralConfig":
        """A small config for tests: same structure, toy sizes."""
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=64,
                   max_seq_len=256, dtype="float32")


@dataclass(frozen=True)
class MelConfig(_Base):
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_mean: float = -5.5419  # normalization constants of token-Voicebox
    mel_std: float = 2.1575
    token_sr: int = 50  # unit rate of the XLS-R tokenizer


@dataclass(frozen=True)
class VoiceboxConfig(_Base):
    n_feats: int = 80
    n_tokens: int = 10000  # unit vocab; the embedding has n_tokens + 1 rows
    embedding_dim: int = 1280
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 24
    convpos_width: int = 31
    convpos_groups: int = 16
    convpos_depth: int = 2
    sigma_min: float = 1e-4
    dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "VoiceboxConfig":
        return cls(n_feats=8, n_tokens=32, embedding_dim=16, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_layers=4, convpos_width=7,
                   convpos_groups=4, convpos_depth=2)


@dataclass(frozen=True)
class BigVGANConfig(_Base):
    """nvidia/bigvgan_22khz_80band geometry."""

    num_mels: int = 80
    upsample_initial_channel: int = 1536
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    resblock: str = "1"
    activation: str = "snakebeta"
    snake_logscale: bool = True
    sampling_rate: int = 22050
    fused_act: bool = True  # up -> snake -> down as one kernel (K3)

    @classmethod
    def tiny(cls) -> "BigVGANConfig":
        return cls(num_mels=8, upsample_initial_channel=32, upsample_rates=(4, 2),
                   upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1, 3, 5),))

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


@dataclass(frozen=True)
class XlsrConfig(_Base):
    """wav2vec2 XLS-R 1B geometry: a 7-layer conv extractor (320x down to
    50 Hz at 16 kHz), 48 transformer layers, features tapped after layer 35
    and assigned to 10,000 k-means centroids."""

    conv_channels: int = 512
    conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_heads: int = 16
    num_layers: int = 48
    output_layer: int = 35
    num_clusters: int = 10000
    conv_pos_width: int = 128
    conv_pos_groups: int = 16
    layer_norm_first: bool = True
    sample_rate: int = 16000
    dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "XlsrConfig":
        return cls(conv_channels=16, conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2),
                   hidden_size=32, intermediate_size=64, num_heads=4, num_layers=4,
                   output_layer=3, num_clusters=64, conv_pos_width=16, conv_pos_groups=4)


@dataclass(frozen=True)
class TrainConfig(_Base):
    """LM training (train/lm.py, train/lora.py): AdamW over f32 masters with
    a clipped global norm and a warmup-cosine (or linear) schedule."""

    learning_rate: float = 2e-5
    lr_schedule: str = "cosine"
    warmup_ratio: float = 0.03
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 2
    grad_accum: int = 1
    max_steps: int = 1000
    seed: int = 42
    dp: int = 1  # data-parallel degree (one GPU: 1)
    tp: int = 1  # tensor-parallel degree (one GPU: 1)
    remat: bool = True  # recompute each decoder layer in backward
    # lm_head + CE per ce_chunk tokens, recomputed in backward, so the full
    # [T, vocab] f32 logits never exist; 0 = unchunked
    ce_chunk: int = 1024
    save_every: int = 1000
    keep_checkpoints: int = 2


@dataclass(frozen=True)
class CfmTrainConfig(_Base):
    """token-Voicebox training."""

    learning_rate: float = 1e-4
    grad_clip: float = 0.2
    batch_size: int = 8
    out_size_seconds: int = 16
    p_uncond: float = 0.2
    p_drop: float = 0.3
    r_min: float = 0.7
    r_max: float = 1.0
    seed: int = 37
    n_epochs: int = 10000
    save_every: int = 1
    dp: int = 1


@dataclass(frozen=True)
class EngineConfig(_Base):
    """The paged serving engine (engine/paged.py).  `runahead` turns depth-1
    chain run-ahead on.  `mixed_prefill` coalesces prefill chunks into the
    decode batch while prompts wait and at least `mixed_min_decode` slots
    decode, up to `mixed_prefill_rows` chunk rows per link (False: drain
    chunks back to back, decode between bursts); either schedule gives the
    same greedy tokens, with float or W8A8 weights.  `spec_k` is the tokens
    a speculative round drafts (engines built with a draft), `ngram_max_n`
    the longest suffix an ngram proposal matches."""

    page_size: int = 256  # tokens per KV page
    max_pages_per_seq: int = 32
    max_batch_size: int = 8
    prefill_chunk: int = 256  # prompt tokens prefilled per engine step
    prefill_chunks_per_tick: int = 4  # chunks drained per tick while prompts wait
    n_pages: Optional[int] = None  # pool size; None = max_batch_size * max_pages_per_seq
    spec_k: int = 4
    ngram_max_n: int = 3
    decode_horizon: int = 8  # tokens decoded per host sync (chained steps)
    kv_dtype: Optional[str] = None  # None = model dtype, "int8" = per-(head, token) scales
    mixed_prefill: bool = True
    mixed_min_decode: int = 3
    mixed_prefill_rows: int = 8
    runahead: bool = True
