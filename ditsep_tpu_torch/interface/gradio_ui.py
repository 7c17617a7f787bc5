"""The gradio demo UI over the interface backends (port of
ditsep_tpu/interface/gradio_ui.py; reference: src/inference/
run_gradio.py:7-32, stable-audio-tools interface/gradio.py:30-425 and
interfaces/diffusion_cond.py).

The tabs and their knobs are the JAX package's (separation, unconditional
and prompted generation, the autoencoder round trip, the token LM); every
callback goes through the port's testable backends in
``interface/app.py``, which run on their models' device. Gated on the
optional ``gradio`` package, which neither this repository's environments
nor the card's machine install: without it ``create_ui`` raises
ImportError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ditsep_tpu_torch.interface.app import (
    AutoencoderApp, GenerationApp, LMApp, SeparationApp, spectrogram_preview,
)


def _audio_in(wav_tuple):
    """gradio's (rate, samples) audio value -> float32 samples."""
    _, wav = wav_tuple
    return np.asarray(wav, np.float32)


def create_ui(separation: Optional[SeparationApp] = None,
              autoencoder: Optional[AutoencoderApp] = None,
              generation: Optional[GenerationApp] = None,
              lm: Optional[LMApp] = None,
              fs: int = 8000):
    """Build the demo UI from any subset of backends; call ``.launch()``
    on the returned ``gradio.Blocks``."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; `pip install gradio` in a serving "
            "environment to use the demo UI") from e

    with gr.Blocks(title="ditsep_tpu_torch") as ui:
        gr.Markdown("# ditsep_tpu_torch — diffusion audio toolkit (CUDA)")

        if separation is not None:
            with gr.Tab("Separate"):
                inp = gr.Audio(label="mixture")
                with gr.Row():
                    steps = gr.Slider(2, 100, value=30, step=1,
                                      label="PC steps (N)")
                    snr = gr.Slider(0.1, 1.0, value=0.5, label="snr")
                    corr = gr.Slider(0, 3, value=1, step=1,
                                     label="corrector steps")
                    seed = gr.Number(value=0, precision=0, label="seed")
                btn = gr.Button("Separate")
                outs = [gr.Audio(label=f"source {i}") for i in range(2)]
                spec = gr.Plot(label="spectrograms")

                def _sep(audio, n, s, c, sd):
                    est = separation.process(_audio_in(audio), n, s, c,
                                             int(sd))
                    fig = spectrogram_preview(est[0], fs)
                    return [(fs, np.asarray(e)) for e in est] + [fig]

                btn.click(_sep, inputs=[inp, steps, snr, corr, seed],
                          outputs=outs + [spec])

        if generation is not None:
            with gr.Tab("Generate (unconditional)"):
                with gr.Row():
                    g_steps = gr.Slider(10, 500, value=50, step=1,
                                        label="steps")
                    g_seed = gr.Number(value=0, precision=0, label="seed")
                    g_smin = gr.Number(value=0.3, label="sigma_min")
                    g_smax = gr.Number(value=50.0, label="sigma_max")
                g_btn = gr.Button("Generate")
                g_out = gr.Audio(label="generated")

                def _gen(st, sd, smin, smax):
                    audio = generation.generate_uncond(
                        int(st), 1, int(sd), float(smin), float(smax))
                    return (generation.fs, audio[0].reshape(-1))

                g_btn.click(_gen, inputs=[g_steps, g_seed, g_smin, g_smax],
                            outputs=g_out)

            if generation.routing is not None:
                with gr.Tab("Generate (prompt)"):
                    prompt = gr.Textbox(label="prompt")
                    with gr.Row():
                        c_secs = gr.Number(value=10.0,
                                           label="seconds_total")
                        c_cfg = gr.Slider(1.0, 14.0, value=6.0,
                                          label="CFG scale")
                        c_steps = gr.Slider(10, 500, value=100, step=1,
                                            label="steps")
                        c_seed = gr.Number(value=0, precision=0,
                                           label="seed")
                    c_btn = gr.Button("Generate")
                    c_out = gr.Audio(label="generated")

                    def _genc(pr, secs, cfg, st, sd):
                        cond = {"prompt": pr,
                                "seconds_start": np.zeros((1,), np.float32),
                                "seconds_total": np.full((1,), secs,
                                                         np.float32)}
                        audio = generation.generate_conditional(
                            cond, int(st), float(cfg), 1, int(sd))
                        return (generation.fs, audio[0].reshape(-1))

                    c_btn.click(_genc,
                                inputs=[prompt, c_secs, c_cfg, c_steps,
                                        c_seed],
                                outputs=c_out)

        if autoencoder is not None:
            with gr.Tab("Autoencoder"):
                a_in = gr.Audio(label="input")
                a_noise = gr.Slider(0.0, 1.0, value=0.0,
                                    label="latent noise")
                a_btn = gr.Button("Reconstruct")
                a_out = gr.Audio(label="reconstruction")

                def _codec(audio, noise):
                    rec = autoencoder.process(_audio_in(audio),
                                              float(noise))
                    return (autoencoder.fs, rec)

                a_btn.click(_codec, inputs=[a_in, a_noise], outputs=a_out)

        if lm is not None:
            with gr.Tab("Token LM"):
                with gr.Row():
                    l_len = gr.Slider(8, 1024, value=64, step=1,
                                      label="length (tokens)")
                    l_temp = gr.Slider(0.0, 2.0, value=1.0,
                                       label="temperature")
                    l_topk = gr.Slider(0, 1024, value=250, step=1,
                                       label="top-k")
                    l_topp = gr.Slider(0.0, 1.0, value=0.0, label="top-p")
                    l_seed = gr.Number(value=0, precision=0, label="seed")
                l_btn = gr.Button("Generate")
                l_out = gr.Audio(label="generated")

                def _lm(n, t, k, p, sd):
                    audio = lm.process(int(n), float(t), int(k), float(p),
                                       int(sd))
                    return (lm.fs, np.asarray(audio).reshape(-1))

                l_btn.click(_lm,
                            inputs=[l_len, l_temp, l_topk, l_topp, l_seed],
                            outputs=l_out)
    return ui
