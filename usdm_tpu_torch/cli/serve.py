"""Dependency-free concurrent HTTP serving (stdlib http.server) on one GPU or more.

Port of usdm_tpu/cli/serve.py: a minimal web UI and JSON API over the full
speech-to-speech pipeline.  LLM decoding goes through the continuous-batching
PagedEngine (EngineServer), so concurrent requests interleave their 3-stage
decodes on the card; unit extraction and synthesis serialize on their locks.
Endpoints:

  GET  /           upload page
  POST /respond    multipart (fields: `wav` = user speech, optional
                   `reference` = speaker-reference wav) or a raw wav body
                   -> JSON {user_text, agent_text, n_units, audio_b64};
                   ?audio=1 returns the raw wav instead;
                   ?stream=1 returns Server-Sent Events (paged engine only):
                   `stage` events per delivered chain (text2text events
                   carry the agent text so far), then one `result` event
                   with the JSON above; errors after the stream opens come
                   as an `error` event, and a vanished client aborts the
                   turn (its engine request is cancelled).
                   Query params: top_k, top_p, temperature, seed, n_timesteps
  GET  /health     liveness probe
  GET  /stats      engine telemetry JSON (PagedEngine.stats)

A served turn equals pipe.respond(wav, seed=seed) with the same sampling
parameters: synthesis draws its noise from `seed` as respond() does
(usdm_tpu seeds it with jax.random.PRNGKey(seed)).

Usage:
  python -m usdm_tpu_torch.cli.serve --demo --device cpu --port 8600
  python -m usdm_tpu_torch.cli.serve --model_dir ... --xlsr_dir ... --kmeans ... \\
      --voicebox_dir ... --bigvgan_dir ...

`--device cuda` (the default) raises without a card.  `--tp N` serves the
LM tensor-parallel on N GPUs (engine/tp.py): this process is rank 0 (the
HTTP server, the whole pipeline, the LM's rank-0 slices) and starts N - 1
worker processes that serve their LM slices until it stops, unless
torchrun started the ranks; it raises by name with fewer than N cards
(`--device cpu`: gloo ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = b"""<!doctype html>
<title>usdm-tpu demo</title>
<h1>usdm-tpu spoken dialog</h1>
<form method=post action="/respond?audio=1" enctype=multipart/form-data>
  <p>User speech wav: <input type=file name=wav></p>
  <p>Speaker reference wav (optional): <input type=file name=reference></p>
  <p><button>Respond</button></p>
</form>
"""

# request-body cap: a minute of 48 kHz float32 stereo is ~23 MB; anything
# bigger than this is not a dialog turn
MAX_BODY_BYTES = 64 * 1024 * 1024


def _qnum(q, name, cast, default):
    try:
        return cast(q[name][0])
    except (KeyError, ValueError, IndexError):
        return default


def _parse_multipart(body: bytes, ctype: str) -> dict:
    """A multipart/form-data body -> {field name: bytes} (RFC 7578): the
    declared boundary (quoted or not), each part's Content-Disposition
    `name`, exactly the CRLF framing stripped."""
    boundary = ""
    for param in ctype.split(";")[1:]:
        k, _, v = param.strip().partition("=")
        if k.lower() == "boundary":
            boundary = v.strip('"')
    if not boundary:
        raise ValueError("multipart body without a boundary parameter")
    delim = b"--" + boundary.encode()
    fields: dict = {}
    for part in body.split(delim)[1:]:
        if part.startswith(b"--"):  # closing delimiter
            break
        part = part.lstrip(b"\r\n")
        head, sep, payload = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        name = None
        for line in head.split(b"\r\n"):
            k, _, v = line.decode("latin-1").partition(":")
            if k.strip().lower() != "content-disposition":
                continue
            for item in v.split(";"):
                ik, _, iv = item.strip().partition("=")
                if ik.lower() == "name":
                    name = iv.strip('"')
        if name is not None:
            fields[name] = payload[:-2] if payload.endswith(b"\r\n") else payload
    return fields


def _unlink_turn_files(*paths) -> None:
    for p in paths:
        if p and os.path.exists(p):
            os.unlink(p)


def make_handler(pipe, server, n_timesteps: int):
    """The request handler class over `pipe` (a UsdmPipeline) and `server`,
    an EngineServer (paged, concurrent) or None (the dense path,
    respond(use_paged=False), one request at a time behind a lock)."""
    from usdm_tpu_torch.engine.server import PagedDialogPolicy

    dense_lock = threading.Lock()
    # XLS-R and Voicebox + BigVGAN run one request at a time, so concurrent
    # turns do not double their device workspaces
    xlsr_lock = threading.Lock()
    synth_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            sys.stderr.write("serve: " + fmt % args + "\n")

        def _json(self, code: int, obj) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(obj).encode())

        def do_GET(self):
            if self.path.startswith("/health"):
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")
                return
            if self.path.startswith("/stats"):
                self._json(200, server.engine.stats() if server is not None
                           else {"engine": "dense"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/respond":
                self.send_response(404)
                self.end_headers()
                return
            q = parse_qs(url.query)
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            ref_bytes = b""
            if "multipart/form-data" in ctype:
                try:
                    fields = _parse_multipart(body, ctype)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                wav_bytes = fields.get("wav", b"")
                ref_bytes = fields.get("reference", b"")
            else:
                wav_bytes = body

            steps = _qnum(q, "n_timesteps", int, n_timesteps)
            seed = _qnum(q, "seed", int, 0)
            stream = bool(_qnum(q, "stream", int, 0))
            if stream and server is None:
                self._json(400, {"error": "stream=1 requires the paged engine (not --dense)"})
                return
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(wav_bytes)
                in_path = f.name
            out_path = in_path + ".out.wav"
            ref_path = None
            if ref_bytes:
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                    f.write(ref_bytes)
                    ref_path = f.name
            if stream:
                self._respond_stream(q, in_path, out_path, ref_path, steps, seed)
                return
            try:
                if server is not None:
                    result = self._run_paged_turn(q, in_path, out_path, ref_path, steps, seed)
                else:
                    with dense_lock:
                        result = pipe.respond(
                            in_path, out_path, ref_path, n_timesteps=steps, seed=seed,
                            top_k=_qnum(q, "top_k", int, 1), top_p=_qnum(q, "top_p", float, 1.0),
                            temperature=_qnum(q, "temperature", float, 1.0), use_paged=False)
            except Exception as e:  # noqa: BLE001 - the request's error goes back to its client
                _unlink_turn_files(in_path, out_path, ref_path)
                self._json(500, {"error": str(e)})
                return

            audio_bytes = self._collect_audio(result, in_path, out_path, ref_path)
            if "audio=1" in (url.query or "") and result.agent_units:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("X-User-Text", result.user_text[:512])
                self.send_header("X-Agent-Text", result.agent_text[:512])
                self.end_headers()
                self.wfile.write(audio_bytes)
            else:
                self._json(200, _result_json(result, audio_bytes))

        def _run_paged_turn(self, q, in_path, out_path, ref_path, steps, seed,
                            on_tokens=None, abort_check=None):
            """One dialog turn through the shared engine: unit extraction
            (and the reference's units and mel) under the XLS-R lock, the
            3-stage decode (batched across threads; streamed through
            `on_tokens`), synthesis to `out_path` under the synthesis lock."""
            from usdm_tpu_torch.audio.wav import load_wav, write_wav
            from usdm_tpu_torch.engine.synthesis import prepare_reference

            policy = PagedDialogPolicy(
                server, pipe.tokenizer, max_new_tokens=pipe.max_new_tokens,
                top_k=_qnum(q, "top_k", int, 1), top_p=_qnum(q, "top_p", float, 1.0),
                temperature=_qnum(q, "temperature", float, 1.0), seed=seed,
                on_tokens=on_tokens, abort_check=abort_check)
            wav, _ = load_wav(in_path, sr=pipe.xlsr_cfg.sample_rate)
            reference = None
            with xlsr_lock:
                units = pipe.extract_units(wav)
                if ref_path is not None:
                    reference = prepare_reference(ref_path, pipe.xlsr_params, pipe.xlsr_cfg,
                                                  pipe.decoder.mel_cfg, device=pipe.device)
            result = policy.respond_to_units(units)
            if result.agent_units:
                with synth_lock:
                    audio = pipe.decoder.synthesize(result.agent_units, seed=seed,
                                                    reference=reference, n_timesteps=steps)
                write_wav(out_path, audio, pipe.decoder.mel_cfg.sampling_rate)
            return result

        def _respond_stream(self, q, in_path, out_path, ref_path, steps, seed):
            """?stream=1: a `stage` event per delivered chain (text2text
            events carry the agent text decoded so far), then `result`, then
            close.  A vanished client aborts the turn: the stage's request
            is cancelled on the engine (its slot and pages freed) rather
            than decoding its whole budget for nobody."""
            from usdm_tpu_torch.engine.server import DialogAborted
            from usdm_tpu_torch.ops.sampling import STAGE_TEXT2TEXT

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            gone = False
            text_ids: list = []

            def emit(event, obj):
                nonlocal gone
                if gone:
                    return
                try:
                    self.wfile.write(f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode())
                    self.wfile.flush()
                except OSError:
                    gone = True  # the client went away; the turn aborts

            def on_tokens(stage, delta):
                payload = {"stage": stage, "n_new": len(delta)}
                if stage == STAGE_TEXT2TEXT:
                    text_ids.extend(delta)
                    payload["text"] = pipe.tokenizer.decode(text_ids)
                emit("stage", payload)

            try:
                result = self._run_paged_turn(q, in_path, out_path, ref_path, steps, seed,
                                              on_tokens, abort_check=lambda: gone)
            except DialogAborted:
                _unlink_turn_files(in_path, out_path, ref_path)
                return  # nobody is listening; the engine slot is freed
            except Exception as e:  # noqa: BLE001 - reported to the client as an event
                emit("error", {"error": str(e)})
                _unlink_turn_files(in_path, out_path, ref_path)
                return
            emit("result", _result_json(result, self._collect_audio(result, in_path, out_path,
                                                                     ref_path)))

        @staticmethod
        def _collect_audio(result, in_path, out_path, ref_path) -> bytes:
            audio_bytes = b""
            if result.agent_units and os.path.exists(out_path):
                with open(out_path, "rb") as f:
                    audio_bytes = f.read()
            _unlink_turn_files(in_path, out_path, ref_path)
            return audio_bytes

    return Handler


def _result_json(result, audio_bytes: bytes) -> dict:
    import base64

    return {
        "user_text": result.user_text,
        "agent_text": result.agent_text,
        "n_units": len(result.agent_units),
        "audio_b64": base64.b64encode(audio_bytes).decode(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--model_dir")
    p.add_argument("--xlsr_dir")
    p.add_argument("--kmeans")
    p.add_argument("--voicebox_dir")
    p.add_argument("--bigvgan_dir")
    p.add_argument("--tokenizer_dir")
    p.add_argument("--n_timesteps", type=int, default=15)
    p.add_argument("--demo", action="store_true", help="random tiny pipeline (plumbing check)")
    p.add_argument("--dense", action="store_true",
                   help="serve on the dense single-request path instead of the engine")
    p.add_argument("--page_size", type=int, default=256)
    p.add_argument("--max_pages_per_seq", type=int, default=32)
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--prefill_chunk", type=int, default=256)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: the LM over N GPUs (N divides the 8 kv "
                        "heads)")
    p.add_argument("--draft_dir",
                   help="HF-Mistral dir of a small draft LM: greedy speculative decoding "
                        "(output identical to plain greedy)")
    p.add_argument("--draft",
                   help="training-free draft: 'early-exit:8' (the target's first 8 layers) "
                        "or 'ngram' (prompt-lookup proposals)")
    p.add_argument("--spec_k", type=int, default=4, help="draft tokens per speculative round")
    p.add_argument("--kv_dtype", choices=["bf16", "int8"], default="bf16",
                   help="KV page pool dtype: int8 halves the pages' memory")
    p.add_argument("--int8", action="store_true", help="quantize the LLM to W8A8 int8")
    p.add_argument("--no_vb_int8", action="store_true",
                   help="keep the Voicebox estimator's matmuls in float (the default "
                        "quantizes them to W8A8, as usdm_tpu does)")
    p.add_argument("--no_runahead", action="store_true",
                   help="disable depth-1 chain run-ahead")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without a card)")
    args = p.parse_args(argv)
    if args.tp > 1:
        if args.dense:
            p.error("--dense serves on one device: it takes no --tp")
        from usdm_tpu_torch.engine import tp as TP

        return TP.launch(args.tp, args.device, _serve_rank, args)
    return _serve(args, args.device)


def _engine_config(args):
    from usdm_tpu_torch.core.config import EngineConfig

    return EngineConfig(
        page_size=args.page_size, max_pages_per_seq=args.max_pages_per_seq,
        max_batch_size=args.max_batch_size, prefill_chunk=args.prefill_chunk,
        spec_k=args.spec_k, kv_dtype=None if args.kv_dtype == "bf16" else args.kv_dtype,
        runahead=not args.no_runahead)


def _serve_rank(rank: int, args) -> int:
    """One rank of `--tp`: rank 0 serves HTTP; the others serve their LM
    slices (and the draft's) until rank 0's engine server closes."""
    from usdm_tpu_torch.cli.infer import rank_draft
    from usdm_tpu_torch.engine import tp as TP
    from usdm_tpu_torch.pipeline import serve_lm, worker_lm

    dev = TP.rank_device(args.device)
    if rank == 0:
        return _serve(args, dev, args.tp)
    shard = (args.tp, rank)
    lm, cfg = worker_lm(dev, None if args.demo else args.model_dir, args.int8, shard)
    serve_lm(lm, cfg, _engine_config(args), args.tp, rank_draft(args, dev, shard), dev)
    return 0


def _serve(args, device, tp: int = 1) -> int:
    from usdm_tpu_torch.cli.infer import rank_draft, rank_pipeline

    shard = (tp, 0) if tp > 1 else None
    pipe = rank_pipeline(args, device, shard)
    # a --draft spec is resolved by make_server (early-exit:N, ngram)
    draft = rank_draft(args, pipe.device, shard)
    server = None
    if not args.dense:
        server = pipe.make_server(_engine_config(args), tp=tp, draft=draft)

    httpd = ThreadingHTTPServer(("0.0.0.0", args.port),
                                make_handler(pipe, server, args.n_timesteps))
    print(f"serving on :{args.port} (demo={args.demo}, engine={'paged' if server else 'dense'})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if server is not None:
            server.close()
        pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
