"""``cli.unwrap_model`` on the port's checkpoint directories: the EMA (or
with --no-ema the trained) score model of the best or the latest
checkpoint goes to a flat ``.npz`` that the JAX package's score model
loads and runs within 1e-4 of max|ref| of the port's (the score-model
bar), and that loads back into the port bit for bit; the latent score
model's too; the decoder finetune's and the VAE-GAN's states are refused
with the reason."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ditsep_tpu_torch.cli import unwrap_model
from ditsep_tpu_torch.configs import (
    build_diffsep_trainer, build_latent_trainer, diffsep, latent_diffsep_ouve,
    override,
)
from ditsep_tpu_torch.models.transformer import ContinuousTransformer
from ditsep_tpu_torch.models.weights import (
    load_state, params_from_jax, params_to_jax,
)
from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_latent import TINY as LATENT_TINY
from test_torch_train import TINY

LENGTH = 1200


def _perturbed(module, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in module.state_dict().values():
            t.add_(scale * torch.randn(t.shape, generator=g))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A checkpoint directory of the tiny trainer: a best checkpoint (step
    1) and a later latest one (step 2), each with its model and EMA apart."""
    trainer = build_diffsep_trainer(override(diffsep(), TINY), device="cpu")
    state = trainer.init_state()
    ckdir = tmp_path_factory.mktemp("run") / "checkpoints"
    mgr = CheckpointManager(str(ckdir))
    saved = {}
    for step in (1, 2):
        _perturbed(state.model, 10 * step)
        _perturbed(state.ema, 10 * step + 1)
        state.step = step
        if step == 1:
            mgr.save(state, step, {"val/si_sdr": 5.0})
        else:
            mgr.save_latest(state, step)
        saved[step] = {k: {n: t.clone() for n, t in m.state_dict().items()}
                       for k, m in (("model", state.model),
                                    ("ema", state.ema))}
    return trainer, ckdir, saved


def _jax_output(npz):
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, LENGTH)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, LENGTH)))
    params = {"params": jax_load_npz(str(npz), tmpl["params"])}
    return np.asarray(jax.jit(jt.model.apply)(params, *map(jnp.asarray,
                                                            _inputs())))


def _inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2, 2, LENGTH)).astype(np.float32),
            np.array([0.4, 0.9], np.float32),
            rng.standard_normal((2, 1, LENGTH)).astype(np.float32))


@pytest.mark.parametrize("args,step,key", [
    ([], 1, "ema"), (["--no-ema"], 1, "model"),
    (["--which", "latest"], 2, "ema"),
    (["--which", "latest", "--no-ema"], 2, "model")])
def test_unwrapped_npz_runs_in_jax_as_the_port(run, tmp_path, args, step,
                                               key):
    trainer, ckdir, saved = run
    out = tmp_path / "w.npz"
    path = unwrap_model.main(["--ckpt-dir", str(ckdir), "--out", str(out),
                              *args])
    assert ("latest" in path) == (step == 2)
    back = build_diffsep_trainer(override(diffsep(), TINY), device="cpu",
                                 params_npz=str(out))
    for n, t in back.model.state_dict().items():
        assert torch.equal(t, saved[step][key][n]), n
    if key == "ema" and step == 1:
        with torch.no_grad():
            got = back.model.eval()(*map(torch.from_numpy,
                                         _inputs())).numpy()
        want = _jax_output(out)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_unwrap_takes_the_latent_score_model(tmp_path):
    cfg = override(latent_diffsep_ouve(), LATENT_TINY)
    lt = build_latent_trainer(cfg, device="cpu")
    state = lt.init_state()
    _perturbed(state.ema, 3)
    CheckpointManager(str(tmp_path / "ck")).save_latest(state, 4)
    out = tmp_path / "latent.npz"
    unwrap_model.main(["--ckpt-dir", str(tmp_path / "ck"), "--out",
                       str(out), "--which", "latest"])
    back = build_latent_trainer(cfg, device="cpu", params_npz=str(out))
    for n, t in back.model.state_dict().items():
        assert torch.equal(t, state.ema.state_dict()[n]), n


@pytest.mark.parametrize("kind,what", [("decoder", "LDM decoder finetune"),
                                       ("vae", "VAE-GAN")])
def test_unwrap_refuses_the_vae_trainers_states(tmp_path, kind, what):
    lin = torch.nn.Linear(2, 2)
    state = types.SimpleNamespace(state_dict=lambda: {
        "step": 3, kind: lin.state_dict(), f"ema_{kind}": lin.state_dict()})
    CheckpointManager(str(tmp_path / "ck"), monitor="train/loss",
                      mode="min").save(state, 3, {"train/loss": 1.0})
    with pytest.raises(SystemExit, match=what):
        unwrap_model.main(["--ckpt-dir", str(tmp_path / "ck"), "--out",
                           str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()


def test_unwrap_without_checkpoints_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoints"):
        unwrap_model.main(["--ckpt-dir", str(tmp_path), "--out",
                           str(tmp_path / "x.npz"), "--which", "latest"])


def test_params_to_jax_names_a_modules_weights_by_type(run):
    """A module's weights are named by their owner's type and a bare
    state_dict's (what ``unwrap_model`` reads) by rank: the same arrays
    for the score model; a weight whose owner has no JAX counterpart
    raises for the module, however its rank reads."""
    trainer = run[0]
    by_type = params_to_jax(trainer.model)
    by_rank = params_to_jax(trainer.model.state_dict())
    assert by_type.keys() == by_rank.keys()
    assert all(np.array_equal(by_type[k], by_rank[k]) for k in by_type)
    for odd in (torch.nn.LayerNorm(4), torch.nn.ConvTranspose2d(2, 2, 3)):
        with pytest.raises(KeyError, match=type(odd).__name__):
            params_to_jax(torch.nn.Sequential(odd))


def test_params_from_jax_names_the_flax_path_it_cannot_walk(run):
    """Given the model, a flax path whose segment names no submodule
    raises with that path; an NCSN++ tree (``all_modules_i``, without the
    ``backbone`` of the score model's own tree) still loads into the
    score model."""
    model = ContinuousTransformer(16, 1, dim_heads=8)
    flat = params_to_jax(model)
    load_state(model, params_from_jax(flat, model))
    key = next(k for k in flat if k.startswith("layer_0/"))
    bad = key.replace("layer_0/", "layer_7/", 1)
    with pytest.raises(KeyError, match=bad):
        params_from_jax({**flat, bad: flat[key]}, model)
    score = run[0].model
    tree = {k.split("/", 1)[1]: v for k, v in params_to_jax(score).items()
            if k.startswith("backbone/")}
    assert any(k.startswith("all_modules_") for k in tree)
    before = {k: v.clone() for k, v in score.state_dict().items()}
    load_state(score, params_from_jax(tree, score))
    assert all(torch.equal(v, before[k])
               for k, v in score.state_dict().items())
