"""The port's separation path against the JAX package's on the CPU: MixSDE
closed forms, single predictor and corrector steps, the full
DiffSepTrainer.separate with matched noise (1e-3 relative, the bar of
tests/test_full_pipeline_parity.py), the CLI, and the port's import rule.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.sdes import MixSDE as JaxMixSDE
from ditsep_tpu.sdes.correctors import ald2_corrector as jax_ald2
from ditsep_tpu.sdes.predictors import (
    reverse_diffusion_predictor as jax_reverse_diffusion,
)
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.data import read_wav, write_wav
from ditsep_tpu_torch.models.weights import params_from_jax
from ditsep_tpu_torch.sdes import (
    MixSDE, ald2_corrector, pc_sample, reverse_diffusion_predictor,
)
from ditsep_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
TINY = {"model.score_model.nf": 16, "model.score_model.ch_mult": (1, 1, 1),
        "model.score_model.num_res_blocks": 1,
        "model.score_model.attn_resolutions": (64,)}
SDE_KW = dict(d_lambda=2.0, sigma_min=0.05, sigma_max=0.5, N=30)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_mixsde_closed_forms_match_jax():
    js, ts = JaxMixSDE(**SDE_KW), MixSDE(**SDE_KW)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 50)).astype(np.float32)
    mix = rng.standard_normal((3, 1, 50)).astype(np.float32)
    t = np.array([0.03, 0.5, 1.0], np.float32)
    jx, jt, tx, tt = (jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x),
                      torch.from_numpy(t))
    _close(ts.mean(tx, tt), js.mean(jx, jt))
    for a, b in zip(ts.cov_eigval(tt), js.cov_eigval(jt)):
        _close(a, b)
    _close(ts.var(tt), js.var(jt))
    jstd, tstd = js.std(jt, 3), ts.std(tt, 3)
    _close(tstd.a, jstd.a)
    _close(tstd.b, jstd.b)
    _close(ts.std_scalar(tstd), js.std_scalar(jstd))
    _close(ts.mult_std(tstd, tx), js.mult_std(jstd, jx))
    _close(ts.mult_std_inv(tstd, tx), js.mult_std_inv(jstd, jx))
    for a, b in zip(ts.drift_diffusion(tx, tt), js.drift_diffusion(jx, jt)):
        _close(a, b)
    _close(ts.prior_from_noise(tx, x.shape, torch.from_numpy(mix)),
           js.prior_from_noise(jx, x.shape, jnp.asarray(mix)))


@pytest.mark.parametrize("scale", [1.0, 0.0])  # 0: std clipped at 1e-5
def test_normalize_batch_matches_jax(scale):
    from ditsep_tpu.utils.separate import normalize_batch as jax_normalize
    from ditsep_tpu_torch.utils.separate import denormalize_batch
    from ditsep_tpu_torch.utils.separate import normalize_batch
    rng = np.random.default_rng(5)
    mix = (scale * rng.standard_normal((3, 1, 200))).astype(np.float32)
    tgt = rng.standard_normal((3, 2, 200)).astype(np.float32)
    (jm, jt), jmean, jstd = jax_normalize((jnp.asarray(mix), jnp.asarray(tgt)))
    (m, t), mean, std = normalize_batch((torch.from_numpy(mix),
                                         torch.from_numpy(tgt)))
    for a, b in ((m, jm), (t, jt), (mean, jmean), (std, jstd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(denormalize_batch(m, mean, std).numpy(), mix,
                               atol=1e-5)


def test_read_wav_matches_jax(tmp_path):
    from ditsep_tpu.data.wsj0_mix import read_wav as jax_read_wav
    rng = np.random.default_rng(6)
    path = str(tmp_path / "x.wav")
    write_wav(path, 0.5 * rng.standard_normal(500).astype(np.float32), 8000)
    data, fs = read_wav(path)
    jdata, jfs = jax_read_wav(path)
    assert fs == jfs == 8000 and data.dtype == np.float32
    np.testing.assert_array_equal(data, jdata)


def _score_fns():
    w = np.linspace(-0.7, 0.9, 2, dtype=np.float32).reshape(1, 2, 1)
    return (lambda x, t, y: -x * jnp.asarray(w) + 0.3 * y * t[:, None, None],
            lambda x, t, y: -x * torch.from_numpy(w) + 0.3 * y * t[:, None, None])


@pytest.mark.parametrize("step", ["reverse_diffusion", "ald2"])
def test_single_steps_match_jax(step):
    js, ts = JaxMixSDE(**SDE_KW), MixSDE(**SDE_KW)
    jscore, tscore = _score_fns()
    rng = np.random.default_rng(1)
    x, y, z = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 2, 40), (2, 1, 40), (2, 2, 40)))
    t = np.array([0.7, 0.2], np.float32)
    if step == "reverse_diffusion":
        jout = jax_reverse_diffusion(js, jscore, jnp.asarray(x),
                                     jnp.asarray(t), jnp.asarray(y),
                                     jax.random.PRNGKey(0),
                                     noise=jnp.asarray(z))
        tout = reverse_diffusion_predictor(
            ts, tscore, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(y), noise=torch.from_numpy(z))
    else:
        jout = jax_ald2(js, jscore, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(y), jax.random.PRNGKey(0), snr=0.5,
                        noises=jnp.asarray(z)[None])
        tout = ald2_corrector(ts, tscore, torch.from_numpy(x),
                              torch.from_numpy(t), torch.from_numpy(y),
                              snr=0.5, noises=torch.from_numpy(z)[None])
    for a, b in zip(tout, jout):
        _close(a, b)


def _tiny_pair(length):
    """The JAX and port trainers on the tiny config with the same weights
    (JAX-initialised, perturbed so that every branch contributes)."""
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tt = build_diffsep_trainer(override(diffsep(), TINY), device="cpu")
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, length)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, length)))
    rng = np.random.default_rng(2)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp):
            np.array(leaf) + 0.05 * rng.standard_normal(leaf.shape).astype(
                np.float32)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                tmpl["params"])[0]}
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(a) for k, a in flat.items()})}
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, params, tt


def test_separate_matches_jax_with_matched_noise():
    b, length, n = 2, 1500, 3
    jt, params, tt = _tiny_pair(length)
    rng = np.random.default_rng(3)
    mix = (0.1 * rng.standard_normal((b, 1, length))).astype(np.float32)
    noise = (rng.standard_normal((b, 2, length)).astype(np.float32),
             rng.standard_normal((n, 1, b, 2, length)).astype(np.float32),
             rng.standard_normal((n, b, 2, length)).astype(np.float32))
    want, nfe_j = jt.separate(params, jax.random.PRNGKey(0),
                              jnp.asarray(mix), N=n, noise=noise)
    got, nfe_t = tt.separate(torch.from_numpy(mix), N=n, noise=noise)
    assert nfe_t == nfe_j == 2 * n
    assert got.shape == (b, 2, length)
    _close(got, want, rtol=1e-3)


def test_pc_sample_generator_is_seeded():
    sde = MixSDE(**SDE_KW)
    _, score = _score_fns()
    y = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(0))
    a, nfe = pc_sample(sde, score, y, N=4,
                       generator=torch.Generator().manual_seed(5))
    b, _ = pc_sample(sde, score, y, N=4,
                     generator=torch.Generator().manual_seed(5))
    assert nfe == 8 and torch.equal(a, b) and torch.isfinite(a).all()
    _, nfe_none = pc_sample(sde, score, y, N=4, corrector="none",
                            generator=torch.Generator().manual_seed(5))
    assert nfe_none == 4


def test_cli_separate_on_cpu(tmp_path):
    from ditsep_tpu_torch.cli.separate import main
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    rng = np.random.default_rng(4)
    for name in ("a.wav", "b.wav"):
        write_wav(str(inp / name),
                  0.3 * rng.standard_normal(1200).astype(np.float32), 8000)
    ov = [f"{k}={v!r}" for k, v in TINY.items()]
    nfe = main(["--config", "diffsep", "--input", str(inp), "--output",
                str(out), "--sampler-N", "2", "--cpu", "--override", *ov])
    assert nfe == 4
    for s in ("s0", "s1"):
        for name in ("a.wav", "b.wav"):
            data, fs = read_wav(str(out / s / name))
            assert fs == 8000 and data.shape == (1200,)
            assert np.isfinite(data).all()


@pytest.mark.parametrize("what", ["latent_mesh", "mesh", "latent_demo",
                                  "ldm_config", "save_figures",
                                  "serve_api_mesh", "serve_gradio"])
def test_unported_options_raise(what, tmp_path, monkeypatch):
    """What is not ported yet raises: the demo server's gradio shell
    (A16.4b). A mesh on either training CLI and on
    serve_api raises without a card and without --cpu (no fallback to the
    CPU). The latent CLI's demo callbacks, train_ldm's demo decodes and
    cli.evaluate's figures, once unported, now run (their flag alone
    reaches no option that raises: each stops on a missing input)."""
    from ditsep_tpu_torch.cli import evaluate as eval_cli
    from ditsep_tpu_torch.cli import serve, serve_api, train_ldm
    from ditsep_tpu_torch.cli import train_diffsep, train_diffsep_latent
    if what.endswith("mesh"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        main = {"latent_mesh": train_diffsep_latent.main,
                "mesh": train_diffsep.main,
                "serve_api_mesh": serve_api.main}[what]
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--mesh", "--synthetic", "--workdir", str(tmp_path)]
                 if what != "serve_api_mesh" else ["--mesh"])
        return
    if what == "latent_demo":  # a VAE file that is not there
        with pytest.raises(FileNotFoundError):
            train_diffsep_latent.main(
                ["--demo-every", "5", "--cpu", "--synthetic", "--workdir",
                 str(tmp_path), "--vae-params", str(tmp_path / "no.npz")])
        return
    if what == "ldm_config":  # an empty latent cache
        with pytest.raises(FileNotFoundError):
            train_ldm.main(["--config", "ldm", "--demo-every", "2", "--cpu",
                            "--latent-cache", str(tmp_path), "--workdir",
                            str(tmp_path)])
        return
    if what == "save_figures":  # a params file that is not there
        with pytest.raises(FileNotFoundError):
            eval_cli.main(["--save-figures", "1", "--cpu", "--synthetic",
                           "--params", str(tmp_path / "no.npz")])
        return
    with pytest.raises(NotImplementedError):
        serve.main(["--gradio", "--cpu"])


def test_serve_vae_config_builds_the_autoencoder_tab(tmp_path, monkeypatch):
    """``cli.serve --vae-config X.json --cpu`` builds the autoencoder tab
    from the stable-audio JSON (the model factory's seeded OobleckVAE on
    the CPU) beside the separation tab, and serves both."""
    import json

    from ditsep_tpu_torch.cli import serve
    from ditsep_tpu_torch.interface import AutoencoderApp, DemoServer
    vae_json = tmp_path / "vae.json"
    vae_json.write_text(json.dumps({
        "model_type": "autoencoder", "sample_rate": 16000, "model": {
            "encoder": {"type": "oobleck", "config": {
                "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
                "latent_dim": 4}},
            "decoder": {"type": "oobleck", "config": {
                "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
                "latent_dim": 2}},
            "bottleneck": {"type": "vae"}, "latent_dim": 2}}))
    served = {}
    monkeypatch.setattr(DemoServer, "serve_forever",
                        lambda self: served.update(srv=self))
    serve.main(["--vae-config", str(vae_json), "--cpu", "--port", "0",
                "--override", *[f"{k}={v!r}" for k, v in TINY.items()]])
    srv = served["srv"]
    try:
        info = srv.info()
        assert info["separation"] and info["autoencoder"]
        ae = srv.autoencoder
        assert isinstance(ae, AutoencoderApp) and ae.fs == 16000
        assert next(ae.vae.parameters()).device.type == "cpu"
        rec = ae.process(np.sin(np.arange(64) / 3.0).astype(np.float32))
        assert rec.shape == (64,) and np.isfinite(rec).all()
    finally:
        srv._httpd.server_close()


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_diffsep_trainer(override(diffsep(), TINY))
    assert resolve_device("cpu").type == "cpu"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("root", ["ditsep_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax_and_nothing_of_ditsep_tpu(root):
    paths = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert paths
    if root == "ditsep_tpu_torch":  # the SDE, trainer and CLI modules too
        names = {p.relative_to(REPO).as_posix() for p in paths}
        assert {f"ditsep_tpu_torch/{m}.py" for m in (
            "sdes/core", "sdes/samplers", "sdes/predictors",
            "sdes/correctors", "training/diffsep", "configs/__init__",
            "configs/build", "data/vctk_demand", "cli/common",
            "cli/separate", "cli/evaluate", "cli/train_diffsep",
            "models/oobleck", "models/weights", "models/score_models",
            "training/diffsep_latent", "data/latent_ds",
            "cli/train_diffsep_latent", "cli/cache_latents",
            "serving/engine", "serving/streaming", "serving/api",
            "serving/__init__", "interface/web", "interface/app",
            "cli/serve_api", "cli/serve", "scripts/serving_bench",
            "ops/stft", "training/auraloss", "training/schedules",
            "models/discriminators", "training/ldm",
            "training/autoencoder", "utils/checkpoint", "cli/train_ldm",
            "cli/validate_vae", "training/diffusion", "training/lm",
            "training/semantic", "training/factory", "training/demo",
            "cli/train_stable")} <= names
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "ditsep_tpu"), f"{path}: imports {mod}"
