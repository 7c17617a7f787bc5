"""The port's diffusion-autoencoder and token-LM trainers
(``training.diffusion.DiffAETrainer``, ``training.lm.LMTrainer``) against
the JAX package's on the CPU: a small diffusion autoencoder (an oobleck
encoder, the adp_1d U-Net) and a small ``AudioLM`` (3 codebooks of 12,
width 16, 2 layers), their JAX parameters redrawn from a seed and carried
over by ``params_from_jax``, inputs made by numpy from a seed, JAX's draws
rebuilt from its keys.

Bars, stated before the runs: the losses 1e-4 of |ref| (the LM with the
clip on and off); two train steps of each (the LM with the clip on, at a
norm below the gradient's, and off) at the train-step bars of
tests/stable_train_parity.py, the loss and grad norm 1e-4 of |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import factory as jf
from ditsep_tpu.models import lm as jl
from ditsep_tpu.training.diffusion import DiffAETrainer as JDiffAE
from ditsep_tpu.training.lm import LMTrainer as JLM
from ditsep_tpu_torch.models import factory as tf
from ditsep_tpu_torch.models import lm as tl
from ditsep_tpu_torch.training.diffusion import DiffAETrainer as TDiffAE
from ditsep_tpu_torch.training.lm import LMTrainer as TLM
from stable_audio_parity import init_shapes, load_jax, redraw
from stable_train_parity import (
    check_steps, jit_step_and_grad, snapshot, torch_tree,
)

LR = 1e-2
DIFFAE = {"model_type": "diffusion_autoencoder", "model": {
    "latent_dim": 3, "downsampling_ratio": 4, "io_channels": 1,
    "encoder": {"type": "oobleck", "config": {
        "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
        "latent_dim": 3}},
    "diffusion": {"type": "adp_1d", "config": {
        "in_channels": 4, "out_channels": 1, "channels": 8,
        "multipliers": [1, 2], "factors": [2], "num_blocks": [1],
        "attentions": [0, 1]}}}}
LM = dict(n_quantizers=3, codebook_size=12, dim=16, depth=2, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grads_t(loss, module):
    named = dict(module.named_parameters())
    gr = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for (k, p), g in zip(named.items(), gr)}


def _diffae_pair(sampler="uniform"):
    jae, tae = (jf.create_model_from_config(DIFFAE),
                tf.create_model_from_config(DIFFAE))
    params = {
        "encoder": redraw(init_shapes(jae.encoder, jnp.zeros((2, 1, 32))),
                          11),
        "diffusion": redraw(init_shapes(jae.diffusion, jnp.zeros((2, 4, 32)),
                                        jnp.zeros((2,))), 12)}
    load_jax(tae, params)
    return (JDiffAE(model=jae, lr=LR, timestep_sampler=sampler), params,
            TDiffAE(model=tae, lr=LR, timestep_sampler=sampler))


def jax_diffae_draws(key, shape, sampler="uniform"):
    """JAX's ``DiffAETrainer.loss`` draws: its key split into the
    timestep's and the noise's."""
    k_t, k_z = jax.random.split(key)
    t = (jax.random.uniform(k_t, shape[:1]) if sampler == "uniform"
         else jax.random.normal(k_t, shape[:1]))
    return {"t": np.array(t), "noise": np.array(jax.random.normal(k_z,
                                                                  shape))}


@pytest.mark.parametrize("sampler", ["uniform", "logit_normal"])
def test_diffae_loss_matches_jax(sampler):
    jt, params, tt = _diffae_pair(sampler)
    x0 = 0.3 * _x((2, 1, 32), 13)
    key = jax.random.PRNGKey(14)
    want = float(jax.jit(jt.loss)(params, key, jnp.asarray(x0)))
    with torch.no_grad():
        got = tt.loss(torch.from_numpy(x0), draws=jax_diffae_draws(
            key, x0.shape, sampler)).item()
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_diffae_two_steps_match_jax():
    """The encoder and the diffusion net both take gradients."""
    jt, params, tt = _diffae_pair()
    st, state = jt.init_state(params), tt.init_state()
    p0 = snapshot(tt.model)
    step = jit_step_and_grad(jt)
    hist_t, hist_j = [], []
    for n in range(2):
        x0 = 0.3 * _x((2, 1, 32), 20 + n)
        key = jax.random.PRNGKey(30 + n)
        draws = jax_diffae_draws(key, x0.shape)
        with torch.enable_grad():
            hist_t.append(_grads_t(tt.loss(torch.from_numpy(x0),
                                           model=state.model, draws=draws),
                                   state.model))
        gj, st, mj = step(st, key, jnp.asarray(x0))
        hist_j.append(torch_tree(gj, tt.model))
        state, mt = tt.train_step(state, torch.from_numpy(x0), draws=draws)
        for k in ("train/loss", "train/grad_norm"):
            assert abs(mt[k].item() - float(mj[k])) <= 1e-4 * abs(
                float(mj[k])), (n, k)
    enc = [k for k in hist_t[0] if k.startswith("encoder.")]
    assert enc and all(np.abs(hist_t[0][k]).max() > 0 for k in enc)
    check_steps(hist_t, hist_j, p0, [LR, LR], snapshot(state.model),
                torch_tree(st.params, tt.model), snapshot(state.ema),
                torch_tree(st.ema_params, tt.model), tt.ema_decay, "DiffAE",
                b1=0.9, b2=0.999, wd=1e-3)


def _lm_pair(clip):
    jm, tm = jl.AudioLM(**LM), tl.AudioLM(**LM)
    params = redraw(init_shapes(jm, jnp.zeros((1, 3, 7), jnp.int32)), 5)
    load_jax(tm, params)
    return (JLM(model=jm, lr=LR, clip_grad_norm=clip), params,
            TLM(model=tm, lr=LR, clip_grad_norm=clip))


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 12, (2, 3, 7))


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_lm_trainer_loss_and_two_steps_match_jax(clip):
    jt, params, tt = _lm_pair(clip)
    tok = _tokens(6)
    want = float(jax.jit(jt.loss)(params, jnp.asarray(tok, jnp.int32)))
    with torch.no_grad():
        got = tt.loss(torch.from_numpy(tok)).item()
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    st, state = jt.init_state(params), tt.init_state()
    p0 = snapshot(tt.model)
    step = jit_step_and_grad(jt)
    hist_t, hist_j = [], []
    for n in range(2):
        tok = jnp.asarray(_tokens(7 + n), jnp.int32)
        with torch.enable_grad():
            hist_t.append(_grads_t(tt.loss(torch.from_numpy(np.asarray(
                tok)), model=state.model), state.model))
        gj, st, mj = step(st, tok)
        hist_j.append(torch_tree(gj, tt.model))
        state, mt = tt.train_step(state, torch.from_numpy(np.asarray(tok)))
        for k in ("train/loss", "train/grad_norm"):
            assert abs(mt[k].item() - float(mj[k])) <= 1e-4 * abs(
                float(mj[k])), (n, k)
        if clip:
            assert float(mj["train/grad_norm"]) > clip  # the clip acts
    check_steps(hist_t, hist_j, p0, [LR, LR], snapshot(state.model),
                torch_tree(st.params, tt.model), snapshot(state.ema),
                torch_tree(st.ema_params, tt.model), tt.ema_decay, "LM",
                clip=clip or np.inf, b1=0.9, b2=0.95, wd=0.1)
