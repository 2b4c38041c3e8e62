"""Streamlit web demo on one GPU.

Port of usdm_tpu/cli/demo_streamlit.py.  Run with:

  streamlit run usdm_tpu_torch/cli/demo_streamlit.py -- \\
      --model_dir ... --xlsr_dir ... --kmeans ... \\
      --voicebox_dir ... --bigvgan_dir ... [--demo] [--device cuda]

Upload user speech (and optionally a speaker reference), tune the sampling
parameters, and play the spoken response: XLS-R units -> the 3-stage
constrained decode on the continuous-batching engine -> Voicebox ->
BigVGAN, as the CLIs run it.  streamlit is imported only by `main`; without
it, `python -m usdm_tpu_torch.cli.serve` is the dependency-free demo.
"""

from __future__ import annotations

import argparse
import sys


def _build_pipeline(args):
    from usdm_tpu_torch.pipeline import UsdmPipeline

    if args.demo:
        return UsdmPipeline.tiny_random(device=args.device)
    return UsdmPipeline.from_pretrained(
        args.model_dir, args.xlsr_dir, args.kmeans, args.voicebox_dir, args.bigvgan_dir,
        args.tokenizer_dir, device=args.device)


def main() -> int:
    try:
        import streamlit as st
    except ImportError:
        print("streamlit is not installed; use `python -m usdm_tpu_torch.cli.serve` for the "
              "dependency-free HTTP demo.", file=sys.stderr)
        return 1

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir")
    parser.add_argument("--xlsr_dir")
    parser.add_argument("--kmeans")
    parser.add_argument("--voicebox_dir")
    parser.add_argument("--bigvgan_dir")
    parser.add_argument("--tokenizer_dir")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()

    st.title("USDM spoken dialog demo")

    @st.cache_resource
    def load():
        pipe = _build_pipeline(args)
        return pipe, pipe.make_server()  # the continuous-batching engine

    pipe, engine_server = load()

    user_file = st.file_uploader("User speech (wav)", type=["wav"])
    ref_file = st.file_uploader("Reference speaker audio (optional)", type=["wav"])
    n_steps = st.slider("ODE timesteps", 2, 50, 15)
    top_k = st.slider("top_k (1 = greedy)", 1, 100, 1)
    top_p = st.slider("top_p", 0.1, 1.0, 1.0)
    temperature = st.slider("temperature", 0.1, 2.0, 1.0)
    seed = st.number_input("Seed", value=0)

    if user_file is not None and st.button("Respond"):
        import tempfile

        from usdm_tpu_torch.engine.server import PagedDialogPolicy

        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            f.write(user_file.read())
            user_path = f.name
        ref_path = None
        if ref_file is not None:
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(ref_file.read())
                ref_path = f.name
        policy = PagedDialogPolicy(
            engine_server, pipe.tokenizer, max_new_tokens=pipe.max_new_tokens,
            top_k=int(top_k), top_p=float(top_p), temperature=float(temperature),
            seed=int(seed))
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as out:
            result = pipe.respond_with_policy(policy, user_path, out.name, ref_path,
                                              n_timesteps=int(n_steps), seed=int(seed))
            st.markdown(f"**User said:** {result.user_text}")
            st.markdown(f"**Agent:** {result.agent_text}")
            if result.agent_units:
                st.audio(out.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
