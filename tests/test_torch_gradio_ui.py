"""The port's gradio shell (interface/gradio_ui.py) on the CPU. gradio is not
installed: without it ``create_ui`` raises ImportError naming gradio, as
tests/test_interface.py:77 holds the JAX package's, and ``cli.serve
--gradio`` reaches it. With a stub ``gradio`` in ``sys.modules`` that
records every widget and callback, both packages' ``create_ui`` build the
same tabs and widgets, and the port's callbacks run against the JAX
package's on the same seeded inputs: the separation tab with the same
draws (1e-3 max|ref| after the peak normalization, the bar of
tests/test_torch_web_interface.py), the autoencoder tab with the same
weights (1e-4 max|ref|); the generation and LM tabs against the port's
direct backend calls (bits)."""
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.utils.checkpoint import save_params_npz as jax_save_npz
from ditsep_tpu_torch.cli.serve import (
    build_autoencoder_app, build_separation_app,
)
from ditsep_tpu_torch.configs import diffsep, override
from ditsep_tpu_torch.sdes.samplers import pc_generator_noise

TINY = {"model.score_model.nf": 16, "model.score_model.ch_mult": (1, 1),
        "model.score_model.num_res_blocks": 1,
        "model.score_model.attn_resolutions": (),
        "model.score_model.n_fft": 126, "model.score_model.hop_length": 32}
VAE_JSON = {"model_type": "autoencoder", "sample_rate": 8000,
            "audio_channels": 1, "model": {
                "encoder": {"type": "oobleck", "config": {
                    "in_channels": 1, "channels": 4, "c_mults": [1, 2],
                    "strides": [2, 2], "latent_dim": 6}},
                "decoder": {"type": "oobleck", "config": {
                    "out_channels": 1, "channels": 4, "c_mults": [1, 2],
                    "strides": [2, 2], "latent_dim": 3}},
                "bottleneck": {"type": "vae"}, "latent_dim": 3}}
SEP_TOL = 1e-3   # of max|ref| (peak-normalized stems), the sampler's bar
AE_TOL = 1e-4    # of max|ref|, a model forward


class _Widget:
    def __init__(self, kind, *args, **kw):
        self.kind, self.args, self.kw = kind, args, kw
        self.clicks = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def click(self, fn, inputs, outputs):
        self.clicks.append((fn, inputs, outputs))


def _stub_gradio(log):
    """A ``gradio`` module whose widgets record themselves in ``log``."""
    mod = types.ModuleType("gradio")
    for kind in ("Blocks", "Markdown", "Tab", "Audio", "Row", "Slider",
                 "Number", "Button", "Plot", "Textbox"):
        def make(*args, _kind=kind, **kw):
            w = _Widget(_kind, *args, **kw)
            log.append(w)
            return w
        setattr(mod, kind, make)
    return mod


def _build(create_ui, monkeypatch, **backends):
    log = []
    monkeypatch.setitem(sys.modules, "gradio", _stub_gradio(log))
    ui = create_ui(**backends)
    layout = [(w.kind, w.kw.get("label"), w.args if w.kind in (
        "Tab", "Button", "Slider") else ()) for w in log if w.kind not in (
        "Blocks", "Markdown")]
    callbacks = [w.clicks[0][0] for w in log if w.kind == "Button"]
    return ui, layout, callbacks


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """The port's and the JAX package's separation and autoencoder
    backends on the same weights (the JAX trees' .npz exports)."""
    from ditsep_tpu.cli.serve import build_autoencoder_app as jax_ae_app
    from ditsep_tpu.interface import SeparationApp as JaxSeparationApp
    tmp = tmp_path_factory.mktemp("apps")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 900)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, 900)))
    jax_save_npz(str(tmp / "score.npz"), tmpl["params"])
    port_sep = build_separation_app(override(diffsep(), TINY),
                                    str(tmp / "score.npz"), device="cpu")

    class _Drawn:
        """JAX's trainer handed the port's draws of the seed."""

        def separate(self, params, key, mix, N, snr, corrector_steps):
            seed = int(np.asarray(key)[-1])  # PRNGKey(seed) = [0, seed]
            noise = tuple(t.numpy() for t in pc_generator_noise(
                torch.Generator().manual_seed(seed), (1, 2, mix.shape[-1]),
                N))
            return jt.separate(params, key, mix, N=N, snr=snr,
                               corrector_steps=corrector_steps, noise=noise)

    jax_sep = JaxSeparationApp(trainer=_Drawn(), params=tmpl, fs=8000)
    (tmp / "vae.json").write_text(json.dumps(VAE_JSON))
    jax_ae = jax_ae_app(str(tmp / "vae.json"))
    from ditsep_tpu.utils.checkpoint import save_params_npz
    save_params_npz(str(tmp / "vae.npz"), jax_ae.params["params"])
    port_ae = build_autoencoder_app(str(tmp / "vae.json"),
                                    str(tmp / "vae.npz"), device="cpu")
    yield {"port": (port_sep, port_ae), "jax": (jax_sep, jax_ae)}
    torch.set_num_threads(n)


def test_create_ui_gated_without_gradio(monkeypatch):
    from ditsep_tpu_torch.interface import create_ui
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        create_ui()


def test_serve_cli_gradio_launches_the_shell(monkeypatch):
    """``cli.serve --gradio --cpu``: the separation tab's UI, launched on
    the host and port given; without gradio, ImportError naming it."""
    from ditsep_tpu_torch.cli import serve
    args = ["--gradio", "--cpu", "--port", "7999", "--override"] + [
        f"{k}={v}" for k, v in TINY.items()]
    log = []
    monkeypatch.setitem(sys.modules, "gradio", _stub_gradio(log))
    launched = []
    monkeypatch.setattr(_Widget, "launch", lambda self, **kw:
                        launched.append(kw), raising=False)
    serve.main(args)
    assert launched == [{"server_name": "127.0.0.1", "server_port": 7999}]
    assert [w.args[0] for w in log if w.kind == "Tab"] == ["Separate"]
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        serve.main(args)


def test_tabs_and_callbacks_match_jax(apps, monkeypatch):
    from ditsep_tpu.interface.gradio_ui import create_ui as jax_create_ui
    from ditsep_tpu_torch.interface import create_ui
    port_sep, port_ae = apps["port"]
    jax_sep, jax_ae = apps["jax"]
    _, layout, cbs = _build(create_ui, monkeypatch, separation=port_sep,
                            autoencoder=port_ae)
    _, jax_layout, jax_cbs = _build(jax_create_ui, monkeypatch,
                                    separation=jax_sep, autoencoder=jax_ae)
    assert layout == jax_layout
    assert [x[2][0] for x in layout if x[0] == "Button"] == [
        "Separate", "Reconstruct"]
    cbs, jax_cbs = (dict(zip(("Separate", "Reconstruct"), c))
                    for c in (cbs, jax_cbs))

    rng = np.random.default_rng(2)
    wav = (0.3 * rng.standard_normal((900, 2))).astype(np.float32)
    got = cbs["Separate"]((8000, wav), 2.0, 0.3, 1.0, 4.0)
    want = jax_cbs["Separate"]((8000, wav), 2.0, 0.3, 1.0, 4.0)
    assert len(got) == len(want) == 3  # two stems and the figure
    for (fs, g), (jfs, w) in zip(got[:2], want[:2]):
        assert fs == jfs == 8000 and g.shape == w.shape == (900,)
        assert np.abs(g - w).max() <= SEP_TOL * np.abs(w).max()
    assert type(got[2]).__name__ == type(want[2]).__name__ == "Figure"

    mono = (0.5 * np.sin(np.arange(400) / 7.0)).astype(np.float32)
    fs, g = cbs["Reconstruct"]((8000, mono), 0.0)
    jfs, w = jax_cbs["Reconstruct"]((8000, mono), 0.0)
    w = np.asarray(w).reshape(-1)
    assert fs == jfs == 8000 and g.shape == w.shape
    assert np.abs(g - w).max() <= AE_TOL * np.abs(w).max()


def test_generation_and_lm_tabs_call_their_backends(monkeypatch):
    """The generation tabs (the prompt tab with a routing) and the LM tab:
    each callback's audio is the direct backend call's, bit for bit."""
    from test_torch_web_interface import _generation_app, _lm_app

    from ditsep_tpu_torch.interface import create_ui
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        gen, lm = _generation_app(), _lm_app(decoder=True)
        _, layout, (uncond, cond, lm_cb) = _build(
            create_ui, monkeypatch, generation=gen, lm=lm)
        tabs = [x[2][0] for x in layout if x[0] == "Tab"]
        assert tabs == ["Generate (unconditional)", "Generate (prompt)",
                        "Token LM"]
        fs, audio = uncond(3.0, 2.0, 0.3, 50.0)
        assert fs == gen.fs
        np.testing.assert_array_equal(
            audio, gen.generate_uncond(3, 1, 2, 0.3, 50.0)[0].reshape(-1))
        fs, audio = cond("unused", 47.0, 4.0, 3.0, 2.0)
        direct = gen.generate_conditional(
            {"seconds_start": np.zeros((1,), np.float32),
             "seconds_total": np.full((1,), 47.0, np.float32)}, 3, 4.0, 1, 2)
        np.testing.assert_array_equal(audio, direct[0].reshape(-1))
        fs, audio = lm_cb(6.0, 1.0, 8.0, 0.0, 3.0)
        assert fs == lm.fs
        np.testing.assert_array_equal(
            audio, np.asarray(lm.process(6, 1.0, 8, 0.0, 3)).reshape(-1))
    finally:
        torch.set_num_threads(n)
