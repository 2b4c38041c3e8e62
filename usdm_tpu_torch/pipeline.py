"""End-to-end spoken dialog pipeline: user wav -> agent wav, in PyTorch.

Port of usdm_tpu/pipeline.py `UsdmPipeline` (respond, respond_with_policy,
the lazy single-caller serving engine, close, tiny_random): XLS-R unit
extraction, the 3-stage unit->text->text->unit chain on the paged engine
(or, with use_paged=False, the dense prefix-reuse loop), Voicebox mel
synthesis with an optional speaker reference prompt, and BigVGAN vocoding,
all on `device` (`cuda` unless the caller asks for the CPU); greedy
speculative decoding through `make_server(draft=)` and
`enable_speculation`.  `from_pretrained` assembles the stack from the
reference's local checkpoint directories (core/checkpoint.py);
`random_init`, `tiny_random` and `full_random` draw random weights.
`lm_int8` / `vb_int8` quantize the LLM projections and the Voicebox
estimator's matmuls to W8A8 (models/quant.py).  `make_server(tp=N)` serves
the LM tensor-parallel over an initialized N-rank group (engine/tp.py):
every rank calls it, rank 0 gets the server, the others follow it until it
closes; the XLS-R, Voicebox and BigVGAN stages run on rank 0 alone
(`serve_lm` serves a bare LM, as a worker rank needs nothing else).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from usdm_tpu_torch.audio.wav import load_wav, write_wav
from usdm_tpu_torch.core import checkpoint as ckpt
from usdm_tpu_torch.core.checkpoint import check_device as _check_device
from usdm_tpu_torch.core.config import (
    BigVGANConfig,
    EngineConfig,
    MelConfig,
    MistralConfig,
    VoiceboxConfig,
    XlsrConfig,
)
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine.dialog import DialogPolicy, DialogResult
from usdm_tpu_torch.engine.synthesis import SpeechDecoder, prepare_reference
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.models import mistral as LM
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.models import xlsr as XL
from usdm_tpu_torch.models.quant import (
    early_exit_draft,
    quantize_llm_params,
    quantize_voicebox_params,
)


def random_lm(lm_cfg: MistralConfig, device, seed: int = 0, lm_int8: bool = False) -> LM.Params:
    """The LM of `UsdmPipeline.random_init(..., seed)`: the same weights,
    drawn alone (a tensor-parallel worker rank builds nothing else)."""
    lm = LM.init_params(lm_cfg, torch.Generator(device=device).manual_seed(seed * 4 + 2), device)
    return quantize_llm_params(lm) if lm_int8 else lm


def tiny_lm_config(tok: Optional[UsdmTokenizer] = None) -> MistralConfig:
    """The LM config of `UsdmPipeline.tiny_random`."""
    tok = tok or UsdmTokenizer.build_test(num_units=32)
    return MistralConfig.tiny(vocab_size=tok.vocab_size)


def worker_lm(device, model_dir: Optional[str] = None, lm_int8: bool = False,
              shard: Optional[tuple] = None):
    """A tensor-parallel worker rank's LM -> (params, config): `shard`'s
    slices of `model_dir`'s LM as from_pretrained loads it, or without a
    directory tiny_random's LM, whole (the engine shards it)."""
    if model_dir is None:
        cfg = tiny_lm_config()
        return random_lm(cfg, device), cfg
    return ckpt.load_mistral(model_dir, dtype="bfloat16", device=device, int8=lm_int8,
                             shard=shard)


def serve_lm(lm_params: LM.Params, lm_cfg: MistralConfig, ecfg: Optional[EngineConfig] = None,
             tp: int = 1, draft=None, device="cuda"):
    """The continuous-batching server over a bare LM (`make_server`'s
    engine).  With `tp` > 1 every rank of the initialized tp-rank group
    calls it: rank 0 gets the EngineServer, the other ranks run its turns
    (engine/tp.py follow) and get None once it closes.  The params may be
    whole or the rank's slices (load_mistral(shard=))."""
    from usdm_tpu_torch.engine import tp as TP
    from usdm_tpu_torch.engine.paged import PagedEngine
    from usdm_tpu_torch.engine.server import EngineServer

    mesh = TP.make_tp_mesh(tp, device) if tp > 1 else None
    if isinstance(draft, str) and draft != "ngram":
        if not draft.startswith("early-exit:"):
            raise ValueError(f"unknown draft spec {draft!r}")
        n = int(draft.split(":", 1)[1])
        draft = (early_exit_draft(lm_params, n), lm_cfg.replace(num_layers=n))
    engine = PagedEngine(lm_params, lm_cfg, ecfg or EngineConfig(), device=device, mesh=mesh,
                         draft=draft)
    if mesh is not None and mesh.rank != 0:
        TP.follow(engine)
        return None
    return EngineServer(engine)


@dataclasses.dataclass
class UsdmPipeline:
    tokenizer: UsdmTokenizer
    lm_params: LM.Params
    lm_cfg: MistralConfig
    xlsr_params: XL.Params
    xlsr_cfg: XlsrConfig
    decoder: SpeechDecoder
    device: torch.device = torch.device("cuda")
    # per-stage cap; None = tokenizer.model_max_length within the engine's pages
    max_new_tokens: Optional[int] = None
    _server: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # respond()'s speculative draft (enable_speculation); None = plain decode
    _draft: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # the dense policy's DenseLoops (caches and CUDA graphs), kept across
    # respond(use_paged=False) turns
    _dense_loops: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.device = _check_device(self.device)

    @classmethod
    def from_pretrained(cls, llm_dir: str, xlsr_dir: str, kmeans_path: str, voicebox_dir: str,
                        bigvgan_dir: str, tokenizer_dir: Optional[str] = None,
                        lm_dtype: str = "bfloat16", lm_int8: bool = False, vb_int8: bool = True,
                        device="cuda", lm_shard: Optional[tuple] = None) -> "UsdmPipeline":
        """The full stack from local checkpoint directories, on `device`:
        the HF LM (`llm_dir`, with its tokenizer unless `tokenizer_dir`),
        XLS-R (an HF dir or fairseq2's .pt) with the k-means .npy, the
        HubMixin Voicebox and BigVGAN.  usdm_tpu's arguments and defaults:
        `lm_int8=True` quantizes the LLM projections to W8A8 as each layer
        loads; `vb_int8=True` (the default) quantizes the Voicebox
        estimator's projections, FFN and skips to W8A8, which usdm_tpu's
        drift gate holds within nRMS 1e-2 of the float estimator
        (scripts/bench_vb_int8.py).  `lm_shard=(tp, rank)` loads only that
        rank's slices of the LM (rank 0 of `make_server(tp=)`; such a
        pipeline serves its LM through that server alone)."""
        device = _check_device(device)
        lm_params, lm_cfg = ckpt.load_mistral(llm_dir, dtype=lm_dtype, device=device,
                                              int8=lm_int8, shard=lm_shard)
        xlsr_params, xlsr_cfg = ckpt.load_xlsr(xlsr_dir, kmeans_path, device=device)
        vb_params, vb_cfg = ckpt.load_voicebox(voicebox_dir, device=device)
        if vb_int8:
            quantize_voicebox_params(vb_params)
        bv_params, bv_cfg = ckpt.load_bigvgan(bigvgan_dir, device=device)
        tokenizer = UsdmTokenizer.load(tokenizer_dir or llm_dir)
        decoder = SpeechDecoder(vb_params, vb_cfg, bv_params, bv_cfg)
        return cls(tokenizer, lm_params, lm_cfg, xlsr_params, xlsr_cfg, decoder, device)

    @classmethod
    def random_init(cls, tok: UsdmTokenizer, lm_cfg: MistralConfig, xl_cfg: XlsrConfig,
                    vb_cfg: VoiceboxConfig, bv_cfg: BigVGANConfig, device="cuda", seed: int = 0,
                    lm_int8: bool = False, vb_int8: bool = False, **kw) -> "UsdmPipeline":
        """A pipeline of the given configs with random weights drawn on
        `device` from generators seeded with `seed`; `lm_int8` / `vb_int8`
        quantize the LLM / Voicebox matmul weights to W8A8 after init (the
        LLM layer by layer, so its float and int8 copies never coexist)."""
        device = _check_device(device)
        gens = [torch.Generator(device=device).manual_seed(seed * 4 + i) for i in range(4)]
        vb = VB.init_params(vb_cfg, gens[0], device)
        decoder = SpeechDecoder(quantize_voicebox_params(vb) if vb_int8 else vb, vb_cfg,
                                BV.init_generator(bv_cfg, gens[1], device), bv_cfg, MelConfig())
        return cls(tok, random_lm(lm_cfg, device, seed, lm_int8), lm_cfg,
                   XL.init_params(xl_cfg, gens[3], device), xl_cfg, decoder, device, **kw)

    @classmethod
    def tiny_random(cls, seed: int = 0, device="cuda", lm_int8: bool = False,
                    vb_int8: bool = False) -> "UsdmPipeline":
        """A structurally complete random pipeline at toy widths (the configs
        of usdm_tpu's tiny_random)."""
        tok = UsdmTokenizer.build_test(num_units=32)
        return cls.random_init(
            tok, tiny_lm_config(tok),
            XlsrConfig.tiny().replace(num_clusters=32),
            VoiceboxConfig.tiny().replace(n_tokens=32, n_feats=80),
            BigVGANConfig.tiny().replace(num_mels=80), device, seed, lm_int8, vb_int8,
            max_new_tokens=16)

    @classmethod
    def full_random(cls, device="cuda", seed: int = 0, lm_int8: bool = False,
                    vb_int8: bool = False) -> "UsdmPipeline":
        """The full-width stack with random weights made on `device`:
        Mistral-7B (bf16, 42,003-id vocab), XLS-R 1B, Voicebox, BigVGAN
        22 kHz/80 band (f32); `lm_int8` / `vb_int8` as in random_init (the
        names and meaning of usdm_tpu's from_pretrained flags; from_pretrained
        loads real checkpoints)."""
        tok = UsdmTokenizer.build_synthetic_full()
        lm_cfg = MistralConfig()
        if tok.vocab_size != lm_cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {tok.vocab_size} != LM vocab {lm_cfg.vocab_size}")
        return cls.random_init(tok, lm_cfg, XlsrConfig(), VoiceboxConfig(), BigVGANConfig(),
                               device, seed, lm_int8, vb_int8)

    # ------------------------------------------------------------------ api
    def extract_units(self, wav: np.ndarray) -> list:
        return XL.extract_units_bucketed(self.xlsr_params, self.xlsr_cfg, wav,
                                         device=self.device)

    def make_server(self, ecfg: Optional[EngineConfig] = None, tp: int = 1, draft=None):
        """The continuous-batching serving engine over the LM, on its loop
        thread (build one PagedDialogPolicy per conversation on top).
        `draft` enables greedy speculative decoding: `(params, cfg)` of a
        separate small LM, `"early-exit:N"` for a self-draft of the target's
        first N layers (sharing its tensors), or `"ngram"` for draft-free
        prompt-lookup proposals.  The tokens are plain greedy's either way.
        `tp` > 1 shards the LM, its pool and the draft over the initialized
        tp-rank group (`serve_lm`: the other ranks get None when rank 0's
        server closes); it raises by name without such a group or without
        tp GPUs."""
        return serve_lm(self.lm_params, self.lm_cfg, ecfg, tp, draft, self.device)

    def enable_speculation(self, draft) -> None:
        """Attach a speculative-decoding draft to the respond() path:
        `(params, cfg)`, `"early-exit:N"` or `"ngram"` (draft-free, the
        stage-C lever: unit streams repeat).  The tokens do not change; only
        speed depends on the draft's agreement.  Closes the lazy dialog
        server, so the next turn builds one with the draft."""
        self.close()
        self._draft = draft

    def _dialog_server(self):
        """Lazy single-caller engine of respond(): one slot, 16-token decode
        chains, 64-token pages (stage B/C prefix reuse), 512-token chunks,
        and the draft of enable_speculation, if any."""
        if self._server is None:
            self._server = self.make_server(EngineConfig(
                max_batch_size=1, decode_horizon=16, page_size=64, max_pages_per_seq=128,
                prefill_chunk=512), draft=self._draft)
        return self._server

    def close(self) -> None:
        """Stop the dialog engine's thread and free the dense loops' caches."""
        if self._server is not None:
            self._server.close()
            self._server = None
        self._dense_loops.clear()

    def respond(self, input_path: str, output_path: Optional[str] = None,
                reference_path: Optional[str] = None, n_timesteps: int = 50, seed: int = 0,
                top_k: int = 1, top_p: float = 1.0, temperature: float = 1.0,
                use_paged: bool = True) -> DialogResult:
        """Full speech-to-speech turn; writes the agent waveform if
        `output_path` is given and returns the intermediate text/units.
        Greedy by default.  `reference_path` adapts the agent's voice to a
        speaker's clip (a renoised speech prompt); `use_paged=False` decodes
        with the dense prefix-reuse DialogPolicy instead of the paged engine
        (usdm_tpu's parity route for HF generate)."""
        if use_paged:
            from usdm_tpu_torch.engine.server import PagedDialogPolicy

            policy = PagedDialogPolicy(self._dialog_server(), self.tokenizer,
                                       max_new_tokens=self.max_new_tokens, top_k=top_k,
                                       top_p=top_p, temperature=temperature, seed=seed)
        else:
            policy = self.dense_policy(top_k=top_k, top_p=top_p, temperature=temperature,
                                       seed=seed)
        return self.respond_with_policy(policy, input_path, output_path, reference_path,
                                        n_timesteps, seed)

    def dense_policy(self, **kw) -> DialogPolicy:
        """respond(use_paged=False)'s DialogPolicy over the pipeline's LM,
        sharing the pipeline's dense loops; `kw` as DialogPolicy takes."""
        return DialogPolicy(self.lm_params, self.lm_cfg, self.tokenizer,
                            max_new_tokens=self.max_new_tokens, loops=self._dense_loops, **kw)

    def respond_with_policy(self, policy, input_path: str, output_path: Optional[str] = None,
                            reference_path: Optional[str] = None, n_timesteps: int = 50,
                            seed: int = 0, trace: Optional[dict] = None) -> DialogResult:
        """Speech-to-speech turn with a caller-supplied dialog policy (any
        object with respond_to_units).  `trace`, when given, receives the
        user units, the agent audio and the wall time of each phase (`ref_s`:
        the reference's units and mel, 0 without one)."""
        t0 = time.perf_counter()
        wav, _ = load_wav(input_path, sr=self.xlsr_cfg.sample_rate)
        user_units = self.extract_units(wav)
        t1 = time.perf_counter()
        result = policy.respond_to_units(user_units)
        t2 = time.perf_counter()
        reference = None
        if reference_path:
            reference = prepare_reference(reference_path, self.xlsr_params, self.xlsr_cfg,
                                          self.decoder.mel_cfg, device=self.device)
        t_ref = time.perf_counter()
        if result.agent_units:
            audio = self.decoder.synthesize(result.agent_units, seed=seed, reference=reference,
                                            n_timesteps=n_timesteps)
        else:
            audio = np.zeros(0, np.float32)
        t3 = time.perf_counter()
        if output_path is not None and len(audio):
            write_wav(output_path, audio, self.decoder.mel_cfg.sampling_rate)
        if trace is not None:
            trace.update(user_units=user_units, audio=audio, xlsr_s=t1 - t0, dialog_s=t2 - t1,
                         ref_s=t_ref - t2, synth_s=t3 - t_ref)
        return result
