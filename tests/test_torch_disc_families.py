"""The port's discriminator families beyond Encodec
(``models/discriminators.py``: Oobleck, the HiFi-GAN period
discriminator, DAC's MPD / MSD / MRD and their combination, the constant-Q
discriminator, BigVGAN) and their losses against the JAX package's on the
CPU: the JAX parameters redrawn from a seed, carried over by
``params_from_jax`` through each family's ``flax_names``; audio made by
numpy from a seed.

Bars, stated before the runs: every logit and feature map 1e-5 of
max|ref|; the parameters back to JAX's tree bit for bit; ``dac_gan_loss``
(least squares and hinge), ``discriminator_loss`` (the hinge families
and DAC / BigVGAN) and ``discriminator_loss_terms`` 1e-5 of |ref|; the discriminator loss's gradient
w.r.t. the parameters, and the generator losses' w.r.t. the fakes, with
fakes at half the reals' amplitude, 1e-3 of each leaf's max|ref| (with
the hinge, at least 1e-4 of the largest leaf's max, the floor of
tests/test_torch_auraloss.py:grad_bar);
``create_discriminator_from_config`` on every type builds the family
JAX's builds, with JAX's parameter shapes (DAC with its MSD), and refuses
an Encodec ``win_lengths`` other than its ``n_ffts`` and an unknown
type.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import discriminators as jd
from ditsep_tpu_torch.models import discriminators as td
from ditsep_tpu_torch.models.weights import (
    disc_params_to_jax, params_from_jax, params_to_jax,
)
from stable_audio_parity import flat, init_shapes, load_jax, redraw

T = 4096
T_CQT = 8192 + 512  # the 8 kHz CQT frames 8,192 samples


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _audio(b, c, t, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, c, t))
            ).astype(np.float32)


# name -> (JAX module, port module, channels, samples)
FAMILIES = {
    "oobleck": (lambda: jd.OobleckDiscriminator(capacity=4),
                lambda: td.OobleckDiscriminator(2, capacity=4), 2, T),
    "multi_period": (
        lambda: jd.MultiPeriodDiscriminator(periods=(2, 3), capacity=4),
        lambda: td.MultiPeriodDiscriminator(2, (2, 3), capacity=4), 2, T),
    "mpd": (lambda: jd.MPD(3, channels=(8, 16, 16)),
            lambda: td.MPD(3, 2, channels=(8, 16, 16)), 2, T),
    "msd": (lambda: jd.MSD(2), lambda: td.MSD(2, 1), 1, T),
    "mrd": (lambda: jd.MRD(512, ch=8), lambda: td.MRD(512, ch=8), 2, T),
    "cqt": (lambda: jd.CQTDiscriminator(ch=8),
            lambda: td.CQTDiscriminator(ch=8), 1, T_CQT),
    "dac": (lambda: jd.DACDiscriminator(periods=(2,), fft_sizes=(256,)),
            lambda: td.DACDiscriminator(1, periods=(2,), fft_sizes=(256,)),
            1, T),
    "big_vgan": (lambda: jd.BigVGANDiscriminator(periods=(2,)),
                 lambda: td.BigVGANDiscriminator(1, periods=(2,)), 1, T_CQT),
}
_CACHE = {}


def family(name):
    """(JAX module, its params, the port's module with them, channels,
    samples), cached."""
    if name not in _CACHE:
        jctor, tctor, c, t = FAMILIES[name]
        jm, tm = jctor(), tctor()
        params = redraw(init_shapes(jm, jnp.zeros((1, c, t))),
                        len(name), scale=1.0)
        load_jax(tm, params)
        _CACHE[name] = (jm, params, tm, c, t)
    return _CACHE[name]


def _nchw(a):
    """A JAX map in the port's layout: NHWC -> NCHW (the 1-D maps are
    NCW on both sides)."""
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _maps(out):
    """Every array of a family's output, in order, flattened."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _maps(o)]
    return [out]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax(name):
    jm, params, tm, c, t = family(name)
    x = _audio(2, c, t, 1)
    want = _maps(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _maps(tm(torch.from_numpy(x)))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        w = _nchw(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    back = params_to_jax(tm)
    ref = {k[len("params/"):]: v for k, v in flat(params).items()}
    assert set(back) == set(ref)
    assert all(np.array_equal(back[k], v) for k, v in ref.items())


@pytest.mark.parametrize("name", ["dac", "big_vgan"])
def test_dac_gan_loss_both_modes_match_jax(name):
    """Least squares and hinge, and ``discriminator_loss``'s dispatch to
    the least squares."""
    jm, params, tm, c, t = family(name)
    reals, fakes = _audio(2, c, t, 2), 0.5 * _audio(2, c, t, 3)
    want = jax.jit(lambda p, r, f: (
        jd.dac_gan_loss(jm, p, r, f), jd.dac_gan_loss(jm, p, r, f, True),
        jd.discriminator_loss(jm, p, r, f)))(params, reals, fakes)
    r, f = torch.from_numpy(reals), torch.from_numpy(fakes)
    with torch.no_grad():
        got = (td.dac_gan_loss(tm, r, f), td.dac_gan_loss(tm, r, f, True),
               td.discriminator_loss(tm, r, f))
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w)), (g, w)


@pytest.mark.parametrize("name", ["dac", "oobleck", "multi_period"])
def test_loss_gradients_match_jax(name):
    """``discriminator_loss``: DAC's least squares, the hinge of Oobleck
    and the period discriminator. With the hinge a leaf's bar is at least
    1e-4 of the largest leaf's max (tests/test_torch_auraloss.py:
    grad_bar's floor): a leaf whose gradient is a near-cancelled sum of
    active hinges is small against the rest."""
    jm, params, tm, c, t = family(name)
    reals, fakes = _audio(2, c, t, 2), 0.5 * _audio(2, c, t, 3)

    def jax_all(p, r, f):
        def gen(g):
            _, adv, fm = jd.discriminator_loss(jm, p, r, g)
            return adv + fm
        return (jd.discriminator_loss(jm, p, r, f),
                jax.grad(lambda q: jd.discriminator_loss(jm, q, r, f)[0])(p),
                jax.grad(gen)(f))
    want, g_params, g_fakes = jax.jit(jax_all)(params, reals, fakes)
    r = torch.from_numpy(reals)
    f = torch.from_numpy(fakes).requires_grad_(True)
    got = td.discriminator_loss(tm, r, f)
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w)), (g, w)
    (gf,) = torch.autograd.grad(got[1] + got[2], [f])
    w = np.asarray(g_fakes)
    assert np.abs(gf.numpy() - w).max() <= 1e-3 * np.abs(w).max()
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(td.discriminator_loss(tm, r, f.detach())[0],
                                list(named.values()))
    want_p = {k: v.numpy() for k, v in params_from_jax(
        flat(g_params), tm).items()}
    top = max(np.abs(v).max() for v in want_p.values())
    floor = 0.0 if name == "dac" else 1e-4 * top
    for (k, _), g in zip(named.items(), grads):
        w = want_p[k]
        bar = max(1e-3 * np.abs(w).max(), floor)
        assert np.abs(g.numpy() - w).max() <= bar, k


@pytest.mark.parametrize("name", ["dac", "big_vgan", "oobleck",
                                  "multi_period"])
def test_discriminator_loss_terms_match_jax(name):
    """``discriminator_loss_terms``: the reals' and the fakes' terms (DAC's
    and BigVGAN's least squares, the others' hinge) against the same
    formulas on JAX's logits within 1e-5 of |ref|, and their sum
    ``discriminator_loss``'s dis_loss within 1e-6 relative."""
    jm, params, tm, c, t = family(name)
    reals, fakes = _audio(2, c, t, 2), 0.5 * _audio(2, c, t, 3)
    least_squares = name in ("dac", "big_vgan")
    apply = jax.jit(jm.apply)

    def logits(x):
        out = apply(params, jnp.asarray(x))
        return [fm[-1] for fm in out] if least_squares else list(out[0])

    lr, lf = logits(reals), logits(fakes)
    if least_squares:
        want = (np.mean([jnp.mean((1.0 - s) ** 2) for s in lr]),
                np.mean([jnp.mean(s ** 2) for s in lf]))
    else:
        want = (np.mean([jnp.mean(jax.nn.relu(1.0 - s)) for s in lr]),
                np.mean([jnp.mean(jax.nn.relu(1.0 + s)) for s in lf]))
    r, f = torch.from_numpy(reals), torch.from_numpy(fakes)
    with torch.no_grad():
        got = td.discriminator_loss_terms(tm, r, f)
        dis = td.discriminator_loss(tm, r, f)[0].item()
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w)), (g, w)
    assert abs(sum(g.item() for g in got) - dis) <= 1e-6 * abs(dis)


def test_dac_gan_loss_detaches_only_the_real_maps():
    """The feature distance's gradient flows to the fakes' maps and not
    to the reals' (the generator step moves the VAE through the fakes)."""
    _, _, tm, c, t = family("dac")
    r = torch.from_numpy(_audio(1, c, t, 4)).requires_grad_(True)
    f = torch.from_numpy(_audio(1, c, t, 5)).requires_grad_(True)
    _, _, fm = td.dac_gan_loss(tm, r, f)
    gr, gf = torch.autograd.grad(fm, [r, f], allow_unused=True)
    assert gr is None and gf.abs().max() > 0


def test_discriminator_loss_refuses_other_modules():
    x = torch.zeros(1, 1, 64)
    with pytest.raises(TypeError, match="no discriminator family"):
        td.discriminator_loss(torch.nn.Conv1d(1, 1, 3), x, x)
    with pytest.raises(TypeError):
        td.discriminator_loss(td.MPD(2), x, x)
    with pytest.raises(TypeError, match="no discriminator family"):
        td.discriminator_loss_terms(td.MPD(2), x, x)


CONFIGS = {
    "encodec": {"type": "encodec", "config": {
        "filters": 4, "n_ffts": [256, 128], "hop_lengths": [64, 32],
        "win_lengths": [256, 128], "channels": 2}},
    "oobleck": {"type": "oobleck", "config": {"capacity": 4,
                                              "n_scales": 2}},
    "dac": {"type": "dac", "config": {
        "periods": [2, 3], "rates": [2], "fft_sizes": [256, 128],
        "bands": [[0.0, 0.5], [0.5, 1.0]], "channels": 2}},
    "big_vgan": {"type": "big_vgan", "config": {
        "periods": [2], "cqtd_filters": 32, "cqtd_n_octaves": 9}},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_create_discriminator_from_config_matches_jax(name):
    cfg = CONFIGS[name]
    c, t = 2, T_CQT
    jm = jd.create_discriminator_from_config(cfg, in_channels=c,
                                             sample_rate=8000)
    tm = td.create_discriminator_from_config(cfg, in_channels=c,
                                             sample_rate=8000)
    assert type(tm).__name__ == type(jm).__name__
    shapes = flat(init_shapes(jm, jnp.zeros((1, c, t))))
    want = {k[len("params/"):]: tuple(v.shape) for k, v in shapes.items()}
    back = (disc_params_to_jax(tm) if name == "encodec"
            else params_to_jax(tm))
    assert {k: v.shape for k, v in back.items()} == want
    # seeded by the caller: one seed, one set of weights
    tm.reset_parameters(torch.Generator().manual_seed(0))
    other = td.create_discriminator_from_config(cfg, in_channels=c)
    other.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        tm.state_dict().values(), other.state_dict().values()))


def test_create_discriminator_from_config_refusals():
    cfg = {"type": "encodec", "config": {"n_ffts": [256, 128],
                                         "hop_lengths": [64, 32],
                                         "win_lengths": [256, 64]}}
    for mod in (jd, td):
        with pytest.raises(NotImplementedError, match="win_lengths"):
            mod.create_discriminator_from_config(cfg)
        with pytest.raises(ValueError, match="unknown discriminator"):
            mod.create_discriminator_from_config({"type": "hifigan"})
