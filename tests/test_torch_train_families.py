"""The port's training math for the OUVE, SBVE (EDM) and PriorMix families
against the JAX package's, on the CPU, with JAX's own random draws
(tests/test_torch_train.py:jax_draws).

The EDM-preconditioned ``model_fwd`` (c 'edm' and '1', network scaling
'1/sigma' and '1/t') through a tiny NCSN++; every score-loss component and
every ``training_loss`` variant on the toy score model under OUVESDE,
SBVESDE and PriorMixSDE (init hack 4 where the family's config sets it);
and the gradient of each family's config loss against ``jax.grad``
through the tiny NCSN++. Two train steps of each family are
tests/test_torch_train_step_families.py's.

Tolerances, stated before the runs: model_fwd 1e-4 of max|ref|; the
losses and gradients at tests/test_torch_train.py's bars (per-item losses
1e-4 of max|ref|, each gradient leaf 1e-3 of its own max|ref|, the global
norm 1e-4 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu import configs as jax_configs
from ditsep_tpu import sdes as jsdes
from ditsep_tpu.training.diffsep import DiffSepConfig as JaxConfig
from ditsep_tpu.training.diffsep import DiffSepTrainer as JaxTrainer
from ditsep_tpu_torch import configs as tconfigs
from ditsep_tpu_torch import sdes as tsdes
from ditsep_tpu_torch.models.weights import params_from_jax
from ditsep_tpu_torch.training import DiffSepConfig, DiffSepTrainer
from test_torch_train import (
    COMPONENTS, TINY, VARIANTS, JaxToyScore, ToyScore, W0, B0, _batch,
    _close, flat_torch_layout, jax_draws,
)

SDES = {
    "ouve": ("OUVESDE", dict(theta=1.5, sigma_min=0.05, sigma_max=0.5,
                             N=30)),
    "sbve": ("SBVESDE", dict(k=2.6, c=0.4, eps=1e-8, N=30)),
    "priormix": ("PriorMixSDE", dict(avg_len=16, d_lambda=2.0,
                                     sigma_min=0.05, sigma_max=0.5, N=30)),
}
FAMILIES = {"ouve": "diffsep_ouve", "sbve": "diffsep_sb",
            "priormix": "enhancement"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def toy_pair(sde, **cfg_kw):
    cls, kw = SDES[sde]
    jt = JaxTrainer(model=JaxToyScore(), sde=getattr(jsdes, cls)(**kw),
                    cfg=JaxConfig(**cfg_kw))
    tt = DiffSepTrainer(model=ToyScore(), sde=getattr(tsdes, cls)(**kw),
                        cfg=DiffSepConfig(**cfg_kw))
    params = {"params": {"W": jnp.asarray(W0), "b": jnp.asarray(B0)}}
    return jt, params, tt


def test_type_dispatch():
    for sde, (matrix, edm) in {"ouve": (False, False), "sbve": (False, True),
                               "priormix": (True, False)}.items():
        jt, _, tt = toy_pair(sde)
        assert (tt.is_matrix, tt.is_edm) == (jt.is_matrix, jt.is_edm) == (
            matrix, edm)
        mix, tgt = _batch(b=2, t_len=8)
        want = jt._anchor(jnp.asarray(mix), tgt.shape)
        got = tt._anchor(torch.from_numpy(mix), tgt.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ toy losses ---
@pytest.mark.parametrize("sde", sorted(SDES))
@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_loss_components_match_jax_per_item(sde, name):
    method, kw = COMPONENTS[name]
    jt, params, tt = toy_pair(sde, **kw)
    mix, tgt = _batch()
    key = jax.random.PRNGKey(17)
    want = getattr(jt, method)(params, key, jnp.asarray(mix),
                               jnp.asarray(tgt))
    comp = "score" if name.startswith("score") else name
    draws = jax_draws(tt.cfg, key, *tgt.shape, component=comp)
    got = getattr(tt, method)(tt.model, torch.from_numpy(mix),
                              torch.from_numpy(tgt), draws=draws)
    assert got.shape == (tgt.shape[0],) and bool(torch.isfinite(got).all())
    _close(got.detach(), want)


@pytest.mark.parametrize("sde,name", [
    (sde, name) for sde in sorted(SDES) for name in sorted(VARIANTS)
    # varprop time sampling is the matrix SDEs' (MixSDE's variance)
    if sde == "priormix" or "varprop" not in name])
def test_training_loss_variants_match_jax(sde, name):
    jt, params, tt = toy_pair(sde, init_hack_p=0.5, **VARIANTS[name])
    mix, tgt = _batch(seed=5)
    key = jax.random.PRNGKey(19)
    want = jt.training_loss(params, key, jnp.asarray(mix), jnp.asarray(tgt))
    draws = jax_draws(tt.cfg, key, *tgt.shape)
    got = tt.training_loss(tt.model, torch.from_numpy(mix),
                           torch.from_numpy(tgt), draws=draws)
    _close(got.detach(), want)


# ------------------------------------------- EDM through the NCSN++ ---
def tiny_family_pair(family, length, seed=2):
    """The JAX and port trainers of ``family`` on the tiny config with the
    same weights (JAX-initialised, perturbed so that every layer carries
    gradient)."""
    jt = jax_configs.build_diffsep_trainer(jax_configs.override(
        jax_configs.CONFIG_FAMILIES[family](), TINY))
    tt = tconfigs.build_diffsep_trainer(tconfigs.override(
        tconfigs.CONFIG_FAMILIES[family](), TINY), device="cpu")
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, length)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, length)))
    rng = np.random.default_rng(seed)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp):
            np.array(leaf) + 0.05 * rng.standard_normal(leaf.shape).astype(
                np.float32)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                tmpl["params"])[0]}
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(a) for k, a in flat.items()})}
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, params, tt


@pytest.mark.parametrize("c,scaling", [("edm", "1/sigma"), ("edm", "1/t"),
                                       ("1", "1/sigma")])
def test_edm_model_fwd_matches_jax(c, scaling):
    length = 800
    jt, params, tt = tiny_family_pair("diffsep_sb", length)
    jt = dataclasses.replace(jt, cfg=dataclasses.replace(
        jt.cfg, c=c, network_scaling=scaling))
    tt = dataclasses.replace(tt, cfg=dataclasses.replace(
        tt.cfg, c=c, network_scaling=scaling))
    rng = np.random.default_rng(13)
    xt = (0.3 * rng.standard_normal((3, 2, length))).astype(np.float32)
    mix = (0.3 * rng.standard_normal((3, 1, length))).astype(np.float32)
    t = np.array([1.0, 0.5, 0.03], np.float32)  # t = T: sigma ~ 1e-4
    # eagerly: under jit XLA folds sigma_T (of full_like(t, T)) into a
    # constant that can differ from sigma_t at t = T by an ulp, and then
    # sigma_bart is not sqrt(eps) there (ROADMAP C, reference behaviours)
    want = jt.model_fwd(params, jnp.asarray(xt), jnp.asarray(t),
                        jnp.asarray(mix))
    with torch.no_grad():
        got = tt.model_fwd(torch.from_numpy(xt), torch.from_numpy(t),
                           torch.from_numpy(mix))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES.values()))
def test_gradients_match_jax_grad(family):
    """The family's config loss (init hack 5 with p 0.1 for diffsep_ouve,
    with p 0 for diffsep_sb; hack 4 for enhancement) and its gradient
    through the tiny NCSN++."""
    length = 800
    jt, params, tt = tiny_family_pair(family, length)
    rng = np.random.default_rng(8)
    mix, tgt = _batch(b=2, t_len=length, seed=8)
    mix = mix + 0.01 * rng.standard_normal(mix.shape).astype(np.float32)
    key = jax.random.PRNGKey(21)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jt.training_loss(p, key, jnp.asarray(mix),
                                   jnp.asarray(tgt), train=True)))(params)
    draws = jax_draws(tt.cfg, key, *tgt.shape)
    named = dict(tt.model.named_parameters())
    loss_t = tt.training_loss(tt.model, torch.from_numpy(mix),
                              torch.from_numpy(tgt), draws=draws)
    grads_t = dict(zip(named, torch.autograd.grad(loss_t,
                                                  list(named.values()))))
    _close(loss_t.detach(), loss_j, 1e-4)
    want = flat_torch_layout(grads_j)
    top = max(np.abs(w).max() for w in want.values())
    for k, g in grads_t.items():
        if k.endswith("NIN_1.b"):  # the attention's key bias: exactly 0
            assert max(np.abs(want[k]).max(), g.abs().max()) <= 1e-6 * top
        else:
            _close(g, want[k], 1e-3)
    norm_t = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_t.values()])).item()
    norm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                jax.tree_util.tree_leaves(grads_j))))
    assert abs(norm_t - norm_j) <= 1e-4 * norm_j
