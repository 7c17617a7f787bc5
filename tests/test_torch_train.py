"""The port's training math against the JAX package's, on the CPU.

The source-ordering helpers, the SI-SDR losses and varprop time sampling;
every score-loss variant and every ``training_loss`` branch (init hacks
4-7, train_source_order pit / power / random, varprop time) with JAX's own
random draws, taken by repeating the JAX code's key splits
(ditsep_tpu/training/diffsep.py:200-213, 222-223, 248-259, 295-299,
318-324, 331-335, 342-343, 357-361); gradients against ``jax.grad``
through a tiny NCSN++ score model. The loss variants run on a toy score
model of two parameter vectors, in JAX without jit: what they test is
the loss algebra and the draws; the network's own gradient is the last
test's.

Tolerances, stated before the runs: per-item losses 1e-4 * max|ref|;
gradients, each leaf within 1e-3 * its own max|ref|, the global norm
within 1e-4 relative (the attention's key bias, whose exact gradient is 0,
within 1e-6 of the largest gradient on both sides).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax.traverse_util import unflatten_dict

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.sdes import MixSDE as JaxMixSDE
from ditsep_tpu.training import losses as jax_losses
from ditsep_tpu.training.diffsep import DiffSepConfig as JaxConfig
from ditsep_tpu.training.diffsep import DiffSepTrainer as JaxTrainer
from ditsep_tpu.utils import separate as jax_sep
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.models.weights import params_from_jax
from ditsep_tpu_torch.sdes import MixSDE
from ditsep_tpu_torch.training import DiffSepConfig, DiffSepTrainer, losses
from ditsep_tpu_torch.utils import separate as sep

SDE_KW = dict(d_lambda=2.0, sigma_min=0.05, sigma_max=0.5, N=30)
# a tiny NCSN++ on a short STFT: 64 bins x 64 frames at 800 samples
TINY = {"model.score_model.nf": 16, "model.score_model.ch_mult": (1, 1),
        "model.score_model.num_res_blocks": 1,
        "model.score_model.attn_resolutions": (128,),
        "model.score_model.n_fft": 126, "model.score_model.hop_length": 32}
W0 = np.array([0.7, -0.4], np.float32)
B0 = np.array([0.3, 0.9], np.float32)

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


# ----------------------------------------------------------- utilities ---
def test_source_ordering_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 40)).astype(np.float32)
    x[:, 1] *= 3.0
    key = jax.random.PRNGKey(3)
    want = jax_sep.shuffle_sources(key, jnp.asarray(x))
    u = np.array(jax.random.uniform(key, x.shape[:2]))
    got = sep.shuffle_sources(torch.from_numpy(x), u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sep.power_order_sources(torch.from_numpy(x)).numpy(),
        np.asarray(jax_sep.power_order_sources(jnp.asarray(x))))
    for axis in (1, -1):
        want = jax_sep.select_elem_at_random(key, jnp.asarray(x), axis)
        sel = jax.random.randint(key, (x.shape[0],), 0, x.shape[axis])
        got = sep.select_elem_at_random(torch.from_numpy(x), axis,
                                        sel=torch.from_numpy(np.asarray(sel)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in (40, 37):
        np.testing.assert_array_equal(
            sep.pad_to_hop(torch.from_numpy(x[..., :n]), 8).numpy(),
            np.asarray(jax_sep.pad_to_hop(jnp.asarray(x[..., :n]), 8)))
    # the generator path: a permutation of each item's sources
    s = sep.shuffle_sources(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert torch.equal(s.sort(dim=1).values,
                       torch.from_numpy(x).sort(dim=1).values)


@pytest.mark.parametrize("zero_mean,clamp_db", [(False, None), (True, 30.0)])
def test_si_sdr_matches_jax(zero_mean, clamp_db):
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((4, 2, 300)).astype(np.float32)
    est = (ref[:, ::-1] + 0.3 * rng.standard_normal(ref.shape)).astype(
        np.float32)
    est[0] = ref[0]  # a perfect item: the clamp decides
    kw = dict(zero_mean=zero_mean, clamp_db=clamp_db)
    te, tr, je, jr = (torch.from_numpy(est), torch.from_numpy(ref),
                      jnp.asarray(est), jnp.asarray(ref))
    _close(losses.si_sdr_pairwise(te, tr, **kw),
           jax_losses.si_sdr_pairwise(je, jr, **kw))
    _close(losses.si_sdr_pit(te, tr, **kw),
           jax_losses.si_sdr_pit(je, jr, **kw))
    # val/si_sdr: the positive SI-SDR, mean over the batch
    _close(losses.si_sdr_loss(te, tr, **kw),
           jax_losses.si_sdr_loss(je, jr, reduction="mean", sign_flip=True,
                                  **kw))


def test_sample_time_varprop_matches_jax():
    key = jax.random.PRNGKey(4)
    want = JaxMixSDE(**SDE_KW).sample_time_varprop(key, 16, t_eps=0.03)
    k1, k2 = jax.random.split(key)
    u, acc = (torch.from_numpy(np.array(jax.random.uniform(k, (128,))))
              for k in (k1, k2))
    got = MixSDE(**SDE_KW).sample_time_varprop(None, 16, 0.03, u=u,
                                               accept_u=acc)
    _close(got, want, 1e-6)
    drawn = MixSDE(**SDE_KW).sample_time_varprop(
        torch.Generator().manual_seed(0), 16, 0.03)
    assert drawn.shape == (16,) and bool(((drawn >= 0.03)
                                          & (drawn <= 1.0)).all())


# ------------------------------------------------- JAX's draws, by role ---
def jax_draws(cfg, key, b, n, *t_shape, component=None):
    """The raw draws the JAX code makes for ``training_loss(key)`` under
    ``cfg`` (or for one loss ``component`` called with ``key``), by the
    role names of ditsep_tpu_torch.training.diffsep, for a (b, n,
    *t_shape) target: (T,) waveforms, (D, Tl) latents."""
    d = {}
    shape = (b, n, *t_shape)
    uni = lambda k, s: np.array(jax.random.uniform(k, s))
    nor = lambda k: np.array(jax.random.normal(k, shape))

    def time(k):
        if cfg.time_sampling_strategy == "varprop":
            k1, k2 = jax.random.split(k)
            d["time_u"], d["time_accept_u"] = uni(k1, (8 * b,)), uni(
                k2, (8 * b,))
        else:
            d["time_u"] = uni(k, (b,))

    def score(k):
        k_t, k_z, k_sel = jax.random.split(k, 3)
        time(k_t)
        d["z"] = nor(k_z)
        if cfg.init_hack == 4:
            d["select_u"] = uni(k_sel, (b,))

    def pit(k):
        d["pit_z"] = nor(k)

    def with_pit(k):
        k_t, k_sel, k_z = jax.random.split(k, 3)
        time(k_t)
        d["sel"] = np.asarray(jax.random.randint(k_sel, (b,), 0, 2))
        d["z"] = nor(k_z)

    def allthetime(k):
        k_shuf, k_t, k_z = jax.random.split(k, 3)
        d["shuffle_u"] = uni(k_shuf, (b, n))
        time(k_t)
        d["z"] = nor(k_z)

    def shuffled(other):
        def f(k):
            k_s, k_l = jax.random.split(k)
            d["shuffle_u"] = uni(k_s, (b, n))
            other(k_l)
        return f

    def mixture(k, other):
        k_mask, k_pit, k_other = jax.random.split(k, 3)
        d["mask_u"] = uni(k_mask, (b,))
        pit(k_pit)
        other(k_other)

    if component is not None:
        {"score": score, "init_hack_pit": pit, "with_pit": with_pit,
         "allthetime": allthetime}[component](key)
    elif cfg.init_hack in (5, 6, 7):
        mixture(key, {5: shuffled(score), 6: shuffled(with_pit),
                      7: allthetime}[cfg.init_hack])
    elif cfg.train_source_order == "pit":
        with_pit(key)
    else:
        k_o, k_l = jax.random.split(key)
        if cfg.train_source_order == "random":
            d["shuffle_u"] = uni(k_o, (b, n))
        score(k_l)
    return d


class JaxToyScore(fnn.Module):
    """A score 'network' of two parameter vectors: -W * xt + b * mix * t
    (named as the weight bridge names NIN leaves)."""

    @fnn.compact
    def __call__(self, xt, time, mix, train=False):
        w = self.param("W", lambda k, s: jnp.asarray(W0), (2,))
        b = self.param("b", lambda k, s: jnp.asarray(B0), (2,))
        return (-xt * w[None, :, None]
                + (b[None, :, None] * mix) * time[:, None, None])


class ToyScore(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.from_numpy(W0.copy()))
        self.b = nn.Parameter(torch.from_numpy(B0.copy()))

    def forward(self, xt, time, mix):
        return (-xt * self.W[None, :, None]
                + (self.b[None, :, None] * mix) * time[:, None, None])


def toy_pair(**cfg_kw):
    jt = JaxTrainer(model=JaxToyScore(), sde=JaxMixSDE(**SDE_KW),
                    cfg=JaxConfig(**cfg_kw))
    tt = DiffSepTrainer(model=ToyScore(), sde=MixSDE(**SDE_KW),
                        cfg=DiffSepConfig(**cfg_kw))
    params = {"params": {"W": jnp.asarray(W0), "b": jnp.asarray(B0)}}
    return jt, params, tt


def _batch(b=6, t_len=64, seed=2):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((b, 2, t_len)).astype(np.float32)
    tgt[:, 1] *= 0.5  # unequal powers: the power order is defined
    tgt[:2, 1] = tgt[:2, 0] + 0.01 * rng.standard_normal(t_len).astype(
        np.float32)  # near-equal sources: mmnr < -10 dB, the PIT branch
    return tgt.sum(1, keepdims=True), tgt


COMPONENTS = {
    "score": ("compute_score_loss", {}),
    "score_hack4": ("compute_score_loss", {"init_hack": 4}),
    "init_hack_pit": ("compute_score_loss_init_hack_pit", {}),
    "with_pit": ("compute_score_loss_with_pit", {}),
    "allthetime": ("compute_score_loss_with_pit_allthetime", {}),
}


@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_loss_components_match_jax_per_item(name):
    method, kw = COMPONENTS[name]
    jt, params, tt = toy_pair(**kw)
    mix, tgt = _batch()
    key = jax.random.PRNGKey(7)
    want = getattr(jt, method)(params, key, jnp.asarray(mix),
                               jnp.asarray(tgt))
    comp = "score" if name.startswith("score") else name
    draws = jax_draws(tt.cfg, key, *tgt.shape, component=comp)
    got = getattr(tt, method)(tt.model, torch.from_numpy(mix),
                              torch.from_numpy(tgt), draws=draws)
    assert got.shape == (tgt.shape[0],)
    _close(got.detach(), want)


VARIANTS = {
    "hack5": {"init_hack": 5},
    "hack6": {"init_hack": 6},
    "hack7": {"init_hack": 7},
    "hack4_power": {"init_hack": 4, "train_source_order": "power"},
    "pit": {"init_hack": 0, "train_source_order": "pit"},
    "random": {"init_hack": 0, "train_source_order": "random"},
    "power_varprop": {"init_hack": 0, "train_source_order": "power",
                      "time_sampling_strategy": "varprop"},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_training_loss_variants_match_jax(name):
    jt, params, tt = toy_pair(init_hack_p=0.5, **VARIANTS[name])
    mix, tgt = _batch(seed=3)
    key = jax.random.PRNGKey(11)
    want = jt.training_loss(params, key, jnp.asarray(mix), jnp.asarray(tgt))
    draws = jax_draws(tt.cfg, key, *tgt.shape)
    got = tt.training_loss(tt.model, torch.from_numpy(mix),
                           torch.from_numpy(tgt), draws=draws)
    _close(got.detach(), want)
    # the generator path runs and is reproducible
    runs = [tt.training_loss(tt.model, torch.from_numpy(mix),
                             torch.from_numpy(tgt),
                             generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and bool(torch.isfinite(runs[0]))


def test_draws_must_be_complete():
    _, _, tt = toy_pair()
    mix, tgt = _batch()
    draws = jax_draws(tt.cfg, jax.random.PRNGKey(0), *tgt.shape)
    draws.pop("pit_z")
    with pytest.raises(KeyError, match="pit_z"):
        tt.training_loss(tt.model, torch.from_numpy(mix),
                         torch.from_numpy(tgt), draws=draws)


# --------------------------------------------- gradients through NCSN++ ---
def tiny_ncsnpp_pair(length, seed=2):
    """The JAX and port trainers on the tiny config with the same weights
    (JAX-initialised, perturbed so that every layer carries gradient)."""
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tt = build_diffsep_trainer(override(diffsep(), TINY), device="cpu")
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


def flat_torch_layout(tree):
    """A JAX params-like tree as {torch key: numpy array} in the port's
    layouts."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {k: v.numpy() for k, v in params_from_jax(flat).items()}


def test_gradients_match_jax_grad():
    length = 800
    jt, params, tt = tiny_ncsnpp_pair(length)
    rng = np.random.default_rng(8)
    mix, tgt = _batch(b=2, t_len=length, seed=8)
    mix = mix + 0.01 * rng.standard_normal(mix.shape).astype(np.float32)
    key = jax.random.PRNGKey(12)
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
    assert set(want) - set(grads_t) == {"backbone.all_modules.0.W"}
    assert not want["backbone.all_modules.0.W"].any()  # stop_gradient
    top = max(np.abs(w).max() for w in want.values())
    for k, g in grads_t.items():
        if k.endswith("NIN_1.b"):
            # the attention's key bias: softmax is invariant to it, its
            # exact gradient is 0 and both sides give round-off
            assert max(np.abs(want[k]).max(), g.abs().max()) <= 1e-6 * top
        else:
            _close(g, want[k], 1e-3)
    norm_t = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_t.values()])).item()
    norm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                jax.tree_util.tree_leaves(grads_j))))
    assert abs(norm_t - norm_j) <= 1e-4 * norm_j
