"""The port's diffusion training (ditsep_tpu_torch/training/diffusion.py)
against the JAX package's (ditsep_tpu/training/diffusion.py) on the CPU:
a small DiT (width 32, 2 layers), its JAX parameters redrawn from a seed
and carried over by ``params_from_jax``, inputs made by numpy from a
seed, JAX's draws rebuilt from its keys (``jax_loss_draws``).

Bars, stated before the runs: ``random_inpaint_mask`` (with and without a
padding mask) and ``create_source_mixture`` exact, and the uniform
sampler's timesteps; the logit samplers' timesteps and
``diffusion_targets`` 1e-6 of max|ref| (XLA's float32 sigmoid, normal CDF
and cosine are approximations of their own); ``DiffusionTrainer.loss``
(unconditional, conditional with CFG dropout, inpaint, the mono-stereo
prior, padding-masked; v and rectified flow, the three samplers) 1e-4 of
|ref|; two train steps (the conditional inpaint case with CFG dropout and
a padding mask) at the train-step bars of tests/stable_train_parity.py,
with the loss and grad norm 1e-4 of |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models.dit import DiffusionTransformer as JDiT
from ditsep_tpu.training import diffusion as jdf
from ditsep_tpu_torch.models.dit import DiffusionTransformer as TDiT
from ditsep_tpu_torch.training import diffusion as tdf
from stable_audio_parity import init_shapes, load_jax, redraw
from stable_train_parity import (
    check_steps, jit_step_and_grad, snapshot, torch_tree,
)

B, C, T, S = 3, 2, 16, 4  # batch, channels, samples, mask segments
LR = 1e-2  # the steps' changes well above float32's resolution


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_loss_draws(key, shape, sampler="uniform", cfg=False, inpaint=False,
                   s=S):
    """The draws of JAX's ``DiffusionTrainer.loss(params, key, ...)`` by
    the port's roles: its key split into the timestep's, the noise's, the
    CFG dropout's (the DiT splits it into the cross-attention's and the
    prepend's) and the inpaint mask's (split five ways)."""
    b = shape[0]
    k_t, k_z, k_cfg, k_inp = jax.random.split(key, 4)
    t = (jax.random.uniform(k_t, (b,)) if sampler == "uniform"
         else jax.random.normal(k_t, (b,)))
    d = {"t": t, "noise": jax.random.normal(k_z, shape)}
    if cfg:
        k_cross, k_prep = jax.random.split(k_cfg)
        d["cfg_cross"] = jax.random.uniform(k_cross, (b, 1, 1))
        d["cfg_prepend"] = jax.random.uniform(k_prep, (b, 1, 1))
    if inpaint:
        d.update(jax_mask_draws(k_inp, b, s))
    return {k: np.array(v) for k, v in d.items()}


def jax_mask_draws(key, b, s=S):
    """``random_inpaint_mask``'s integer draws from its key."""
    big = jnp.iinfo(jnp.int32).max
    k_type, k_nseg, k_len, k_start, k_causal = jax.random.split(key, 5)
    return {k: np.array(v) for k, v in {
        "mask_type": jax.random.randint(k_type, (b,), 0, 3),
        "n_segments": jax.random.randint(k_nseg, (b,), 1, s + 1),
        "seg_len": jax.random.randint(k_len, (b, s), 0, big),
        "seg_start": jax.random.randint(k_start, (b, s), 0, big),
        "causal_len": jax.random.randint(k_causal, (b,), 0, big)}.items()}


def _padding_mask(b=B, t=T):
    m = np.ones((b, t), bool)
    m[1, -5:] = False
    m[2, -11:] = False
    return m


@pytest.mark.parametrize("sampler", ["uniform", "logit_normal",
                                     "trunc_logit_normal"])
def test_sample_timesteps_matches_jax(sampler):
    key = jax.random.PRNGKey(1)
    want = np.asarray(jax.jit(lambda k: jdf.sample_timesteps(
        k, 64, sampler))(key))
    raw = np.array(jax.random.uniform(key, (64,)) if sampler == "uniform"
                   else jax.random.normal(key, (64,)))
    got = tdf.sample_timesteps(64, sampler, draws={"t": raw}).numpy()
    if sampler == "uniform":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # from a generator: in [0, 1], one seed one draw
    a, b = (tdf.sample_timesteps(64, sampler, generator=torch.Generator()
                                 .manual_seed(3)) for _ in range(2))
    assert torch.equal(a, b) and a.min() >= 0 and a.max() <= 1
    with pytest.raises(ValueError):
        tdf.sample_timesteps(4, "nope", generator=torch.Generator())


@pytest.mark.parametrize("objective", ["v", "rectified_flow"])
def test_diffusion_targets_match_jax(objective):
    x0, noise = _x((B, C, T), 2), _x((B, C, T), 3)
    t = np.random.default_rng(4).random(B).astype(np.float32)
    want = jax.jit(lambda *a: jdf.diffusion_targets(objective, *a))(
        x0, noise, t)
    got = tdf.diffusion_targets(objective, *map(torch.from_numpy,
                                                (x0, noise, t)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    with pytest.raises(ValueError):
        tdf.diffusion_targets("eps", *map(torch.from_numpy, (x0, noise, t)))


@pytest.mark.parametrize("num_sources", [1, 2, 3])
def test_create_source_mixture_exact_on_jax_draws(num_sources):
    reals = _x((5, 2, 12), 5)
    key = jax.random.PRNGKey(6 + num_sources)
    want = jax.jit(lambda k, r: jdf.create_source_mixture(
        k, r, num_sources))(key, reals)
    k_perm, k_off = jax.random.split(key)
    draws = {"offsets": np.array(jax.random.randint(
        k_off, (5, num_sources), 0, 12)), "shifts": np.array(
        jax.random.randint(k_perm, (num_sources,), 0, 5))}
    got = tdf.create_source_mixture(torch.from_numpy(reals), num_sources,
                                    draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("padded", [False, True])
def test_random_inpaint_mask_exact_on_jax_draws(padded):
    x = _x((8, 2, 40), 8)
    pm = None
    if padded:
        pm = np.ones((8, 40), bool)
        pm[::2, 25:] = False
        pm[3, 2:] = False
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda k, a, m: jdf.random_inpaint_mask(k, a, 6, m))(
        key, x, pm)
    got = tdf.random_inpaint_mask(
        torch.from_numpy(x), 6, None if pm is None else torch.from_numpy(pm),
        draws=jax_mask_draws(key, 8, 6))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mt = jax_mask_draws(key, 8, 6)["mask_type"]
    assert set(mt.tolist()) == {0, 1, 2}  # every mask type drawn


# name -> (trainer kwargs, DiT kwargs, conditioning ids, padded)
CASES = {
    "uncond_trunc": (dict(timestep_sampler="trunc_logit_normal"), {}, {},
                     False),
    "cond_cfg": (dict(cfg_dropout_prob=0.5), dict(
        cond_token_dim=6, global_cond_dim=5, prepend_cond_dim=4),
        dict(cross_attn_cond_ids=("prompt",), global_cond_ids=("seconds",),
             prepend_cond_ids=("lyrics",)), False),
    "inpaint_rf_padded": (dict(inpaint=True, max_mask_segments=S,
                               objective="rectified_flow",
                               cfg_dropout_prob=0.5),
                          dict(cond_token_dim=6, input_concat_dim=C + 1),
                          dict(cross_attn_cond_ids=("prompt",),
                               input_concat_ids=("inpaint_mask",
                                                 "inpaint_masked_input")),
                          True),
    "prior_logit": (dict(mono_stereo_prior=True, cfg_dropout_prob=0.0,
                         timestep_sampler="logit_normal"),
                    dict(input_concat_dim=C),
                    dict(input_concat_ids=("source",)), False),
    "uncond_padded": ({}, {}, {}, True),
}


def _cond(ids):
    """The (embedding, mask) pairs of the conditioning ids used here."""
    cond = {}
    if "prompt" in ids.get("cross_attn_cond_ids", ()):
        m = np.ones((B, 5), bool)
        m[0, 3:] = False
        cond["prompt"] = (_x((B, 5, 6), 10), m)
    if "seconds" in ids.get("global_cond_ids", ()):
        cond["seconds"] = (_x((B, 1, 5), 11), np.ones((B, 1), bool))
    if "lyrics" in ids.get("prepend_cond_ids", ()):
        m = np.ones((B, 2), bool)
        m[1, 1] = False
        cond["lyrics"] = (_x((B, 2, 4), 12), m)
    return cond


def _pair(case, seed=20):
    """(JAX trainer, its params, the port's trainer, cond, padding mask)."""
    tkw, dkw, ids, padded = CASES[case]
    dit = dict(io_channels=C, embed_dim=32, depth=2, num_heads=4, **dkw)
    routing = (jdf.CondRouting(**ids), tdf.CondRouting(**ids)) if ids \
        else (None, None)
    jm, tm = JDiT(**dit), TDiT(**dit)
    cond = _cond(ids)
    x0 = jnp.zeros((B, C, T))
    init_kw = routing[0].gather({
        **{k: (jnp.asarray(e), jnp.asarray(m)) for k, (e, m) in cond.items()},
        "inpaint_mask": (jnp.zeros((B, 1, T)), None),
        "inpaint_masked_input": (x0, None), "source": (x0, None)}) \
        if ids else {}
    params = redraw(init_shapes(jm, x0, jnp.zeros((B,)), **init_kw), seed)
    load_jax(tm, params)
    jt = jdf.DiffusionTrainer(model=jm, routing=routing[0], lr=LR, **tkw)
    tt = tdf.DiffusionTrainer(model=tm, routing=routing[1], lr=LR, **tkw)
    return jt, params, tt, cond, (_padding_mask() if padded else None)


def _jcond(cond):
    return {k: (jnp.asarray(e), jnp.asarray(m)) for k, (e, m) in
            cond.items()} or None


def _tcond(cond):
    return {k: (torch.from_numpy(e), torch.from_numpy(m)) for k, (e, m) in
            cond.items()} or None


def _draws(jt, key):
    return jax_loss_draws(
        key, (B, C, T), jt.timestep_sampler,
        cfg=bool(jt.routing) and jt.cfg_dropout_prob > 0,
        inpaint=jt.inpaint, s=jt.max_mask_segments)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffusion_trainer_loss_matches_jax(case):
    jt, params, tt, cond, pm = _pair(case)
    x0 = _x((B, C, T), 13)
    key = jax.random.PRNGKey(14)
    want = float(jax.jit(jt.loss)(params, key, jnp.asarray(x0),
                                  _jcond(cond), pm))
    with torch.no_grad():
        got = tt.loss(torch.from_numpy(x0), _tcond(cond),
                      None if pm is None else torch.from_numpy(pm),
                      draws=_draws(jt, key)).item()
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_diffusion_trainer_two_steps_match_jax():
    jt, params, tt, cond, pm = _pair("inpaint_rf_padded")
    st = jt.init_state(params)
    state = tt.init_state()
    p0 = snapshot(tt.model)
    step = jit_step_and_grad(jt)
    hist_t, hist_j = [], []
    for n in range(2):
        x0 = _x((B, C, T), 30 + n)
        key = jax.random.PRNGKey(40 + n)
        draws = _draws(jt, key)
        pmt = torch.from_numpy(pm)
        named = dict(state.model.named_parameters())
        with torch.enable_grad():
            loss = tt.loss(torch.from_numpy(x0), _tcond(cond), pmt,
                           model=state.model, draws=draws)
            gr = torch.autograd.grad(loss, list(named.values()),
                                     allow_unused=True)
        hist_t.append({k: np.zeros(p.shape, np.float32) if g is None
                       else g.numpy() for (k, p), g in zip(named.items(),
                                                           gr)})
        gj, st, mj = step(st, key, jnp.asarray(x0), _jcond(cond), pm)
        hist_j.append(torch_tree(gj, tt.model))
        state, mt = tt.train_step(state, torch.from_numpy(x0), _tcond(cond),
                                  pmt, draws=draws)
        for k in ("train/loss", "train/grad_norm"):
            ref = float(mj[k])
            assert abs(mt[k].item() - ref) <= 1e-4 * abs(ref), (n, k)
    assert state.step == 2 == int(st.step)
    check_steps(hist_t, hist_j, p0, [LR, LR], snapshot(state.model),
                torch_tree(st.params, tt.model), snapshot(state.ema),
                torch_tree(st.ema_params, tt.model), tt.ema_decay,
                "DiffusionTrainer", b1=0.9, b2=0.999, wd=1e-3)


def test_draws_from_the_generator():
    """Without draws every draw comes from the generator: one seed, one
    loss; another seed, another."""
    _, _, tt, cond, pm = _pair("inpaint_rf_padded")
    x0 = torch.from_numpy(_x((B, C, T), 50))
    with torch.no_grad():
        a, b, c = (tt.loss(x0, _tcond(cond), torch.from_numpy(pm),
                           generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and torch.isfinite(a) and not torch.equal(a, c)
    with pytest.raises(KeyError, match="noise"):  # draws lack a role
        tt.loss(x0, _tcond(cond), torch.from_numpy(pm), draws={
            "t": np.zeros(B, np.float32)})
