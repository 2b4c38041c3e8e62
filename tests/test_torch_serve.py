"""cli/serve.py and cli/demo_streamlit.py of usdm_tpu_torch on the CPU.

Ports of the four serve tests of tests/test_cli.py on
UsdmPipeline.tiny_random(device="cpu"): concurrent POSTs on the paged
engine, Server-Sent Events, the dense path, multipart reference audio and
the body cap; and a served turn equal to pipe.respond(seed=...) for the
same wav (units, text and the wav's bytes)."""

import argparse
import base64
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from usdm_tpu_torch.audio.wav import write_wav
from usdm_tpu_torch.cli import demo_streamlit, serve
from usdm_tpu_torch.core.config import EngineConfig
from usdm_tpu_torch.pipeline import UsdmPipeline


@pytest.fixture(scope="module")
def user_wav(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("serve") / "user.wav")
    write_wav(path, (rng.standard_normal(16000) * 0.1).astype(np.float32), 16000)
    return path


@pytest.fixture(scope="module")
def pipe():
    p = UsdmPipeline.tiny_random(device="cpu")
    yield p
    p.close()


class Served:
    """An HTTP server over `pipe` on a free local port (engine: an
    EngineServer of `ecfg`, or the dense path when None)."""

    def __init__(self, pipe, ecfg=None):
        self.engine = pipe.make_server(ecfg) if ecfg is not None else None
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         serve.make_handler(pipe, self.engine, n_timesteps=2))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def post(self, qs="", data=b"", headers=None):
        req = urllib.request.Request(self.url + "/respond" + qs, data=data, method="POST",
                                     headers=headers or {})
        return urllib.request.urlopen(req, timeout=600)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.engine is not None:
            self.engine.close()


def _ecfg(batch=4):
    return EngineConfig(page_size=32, max_pages_per_seq=64, max_batch_size=batch,
                        prefill_chunk=256)


def test_serve_http_concurrent_paged(pipe, user_wav):
    """Two simultaneous POSTs both complete on the engine (no global lock),
    sampling parameters by query; /, /health and /stats answer; a garbage
    body is a JSON error."""
    srv = Served(pipe, _ecfg())
    try:
        with urllib.request.urlopen(srv.url + "/health", timeout=30) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(srv.url + "/", timeout=30) as r:
            assert b"usdm-tpu" in r.read()
        body = open(user_wav, "rb").read()
        results = {}

        def post(name, qs=""):
            with srv.post(qs, body) as r:
                results[name] = json.loads(r.read())

        threads = [threading.Thread(target=post, args=("a",)),
                   threading.Thread(target=post, args=("b", "?top_k=5&temperature=1.2&seed=3"))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
            assert not th.is_alive()
        for k in "ab":
            assert "agent_text" in results[k] and "n_units" in results[k]
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["total_finished"] >= 6 and "perf_s" in stats  # 3 stages x 2 turns
        try:
            with srv.post("", b"garbage") as r:
                payload = json.loads(r.read())
        except urllib.error.HTTPError as e:
            payload = json.loads(e.read())
        assert "error" in payload
    finally:
        srv.close()


def _events(raw: str) -> list:
    out = []
    for block in raw.split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.splitlines() if ": " in line)
        if "event" in lines:
            out.append((lines["event"], json.loads(lines["data"])))
    return out


def test_serve_http_sse_stream_equals_respond(pipe, user_wav, tmp_path):
    """?stream=1: `stage` events (text2text ones carry the agent-text
    preview), then a `result` equal to the plain POST's JSON for the same
    seed; that JSON is pipe.respond(seed=5)'s turn: its texts, unit count
    and the wav's bytes.  stream=1 on the dense path is a 400."""
    srv = Served(pipe, _ecfg())
    try:
        body = open(user_wav, "rb").read()
        with srv.post("?stream=1&seed=5", body) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            events = _events(r.read().decode())
        kinds = [k for k, _ in events]
        assert kinds[-1] == "result" and "stage" in kinds[:-1]
        stages = [d["stage"] for k, d in events if k == "stage"]
        assert stages[0] == "unit2text" and "text2unit" in stages
        previews = [d["text"] for k, d in events if k == "stage" and d["stage"] == "text2text"]
        assert previews and all(isinstance(t, str) for t in previews)
        with srv.post("?seed=5", body) as r:
            plain = json.loads(r.read())
        assert events[-1][1] == plain
    finally:
        srv.close()
    out = str(tmp_path / "respond.wav")
    res = pipe.respond(user_wav, out, n_timesteps=2, seed=5)
    assert (plain["user_text"], plain["agent_text"], plain["n_units"]) == (
        res.user_text, res.agent_text, len(res.agent_units))
    if res.agent_units:
        assert base64.b64decode(plain["audio_b64"]) == open(out, "rb").read()
    dense = Served(pipe)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            dense.post("?stream=1", body)
        assert exc.value.code == 400
    finally:
        dense.close()


def test_serve_http_dense_fallback(pipe, user_wav):
    """The dense path (server None: respond(use_paged=False) behind a lock)
    serves a turn; /stats says so."""
    srv = Served(pipe)
    try:
        with srv.post("", open(user_wav, "rb").read()) as r:
            payload = json.loads(r.read())
        assert "agent_text" in payload and "n_units" in payload
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            assert json.loads(r.read()) == {"engine": "dense"}
    finally:
        srv.close()


def _multipart_body(fields):
    boundary = "usdmtpuboundary42"
    out = b""
    for name, data in fields.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{name}"; filename="{name}.wav"\r\n'
                f"Content-Type: audio/wav\r\n\r\n").encode() + data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, f'multipart/form-data; boundary="{boundary}"'


def test_serve_http_multipart_reference(pipe, user_wav, tmp_path):
    """Named multipart fields `wav` and `reference`: the turn equals
    pipe.respond(reference_path=...) (texts and wav bytes), the audio comes
    inline as base64 (no server path); ?audio=1 returns the wav itself; a
    body over the cap is refused with 413."""
    srv = Served(pipe, _ecfg(batch=2))
    try:
        wav_bytes = open(user_wav, "rb").read()
        body, ctype = _multipart_body({"reference": wav_bytes, "wav": wav_bytes})
        with srv.post("?seed=2", body, {"Content-Type": ctype}) as r:
            payload = json.loads(r.read())
        assert "agent_text" in payload and "audio_path" not in payload
        out = str(tmp_path / "ref.wav")
        res = pipe.respond(user_wav, out, user_wav, n_timesteps=2, seed=2)
        assert payload["agent_text"] == res.agent_text
        if res.agent_units:
            audio = base64.b64decode(payload["audio_b64"])
            assert audio[:4] == b"RIFF" and audio == open(out, "rb").read()
            with srv.post("?seed=2&audio=1", body, {"Content-Type": ctype}) as r:
                assert r.headers["Content-Type"] == "audio/wav" and r.read() == audio
        try:
            srv.post("", b"x", {"Content-Length": str(100 * 1024 * 1024)})
            raised = False
        except urllib.error.HTTPError as e:
            raised = e.code == 413
        except urllib.error.URLError:
            raised = True  # the server closed the connection on the bogus length
        assert raised
    finally:
        srv.close()


def test_serve_main_refusals():
    """--tp 2 on a host without two cards raises by name, before any
    process starts; without a card the default --device cuda raises."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices for tp=2"):
            serve.main(["--demo", "--tp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--demo"])


def test_demo_streamlit_build_pipeline(monkeypatch, capsys):
    """_build_pipeline: --demo gives the tiny random pipeline on the asked
    device; otherwise from_pretrained with the checkpoint flags and the
    device.  main() without streamlit says to use cli.serve."""
    ns = dict(model_dir="m", xlsr_dir="x", kmeans="k", voicebox_dir="v", bigvgan_dir="b",
              tokenizer_dir=None, device="cpu")
    p = demo_streamlit._build_pipeline(argparse.Namespace(demo=True, **ns))
    try:
        assert isinstance(p, UsdmPipeline) and p.device.type == "cpu"
    finally:
        p.close()
    seen = {}
    monkeypatch.setattr(UsdmPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **kw: seen.update(args=a, kw=kw) or "pipe"))
    assert demo_streamlit._build_pipeline(argparse.Namespace(demo=False, **ns)) == "pipe"
    assert seen == {"args": ("m", "x", "k", "v", "b", None), "kw": {"device": "cpu"}}
    monkeypatch.setitem(__import__("sys").modules, "streamlit", None)
    assert demo_streamlit.main() == 1
    assert "usdm_tpu_torch.cli.serve" in capsys.readouterr().err
