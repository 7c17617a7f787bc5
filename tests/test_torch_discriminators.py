"""The port's Encodec discriminator (``models/discriminators.py``) and its
weight bridge against the JAX package's on the CPU: JAX-initialised
weights (perturbed so that the biases count) carried across by
``disc_params_from_jax``, inputs made by numpy from a seed.

Tolerances, stated before the runs: the bridge bit for bit both ways;
``MultiScaleSTFTDiscriminator`` logits and every feature map (in_channels
1 and 2, all five of the ldm config's scales at filters 8) 1e-5 of
max|ref|; ``encodec_discriminator_loss`` (normalize_losses on and off)
1e-5 relative; its gradients w.r.t. the discriminator's parameters,
with fakes at half the reals' amplitude, 1e-3 of each leaf's max|ref|;
with both inputs noise of one scale (the hinge's gradient a difference
of two nearly equal means, 8.9e-4 of a leaf's max off float64 in JAX,
5.7e-3 in the port: ``main``), and w.r.t. the fakes in both cases, the
same (the parameters' at least 1e-4 of the largest leaf's: with every
hinge active, conv_post's bias takes exactly 0 and its gain a
near-cancelled sum) plus twice JAX's own float32 error against JAX's
own float64 run (tests/test_torch_auraloss.py:grad_bar); the port's
float64 gradients 1e-6 of each leaf's max of JAX's float64 ones.

Where the port's float32 hinge gradient loses to JAX's (5.7e-3 of a
leaf's max off float64 against 8.9e-4, fakes of the reals' scale): the
convolutions' own float32 rounding on the CPU. Run in float64 with one
stage in float32 (``main``), the normalized STFT gives 7.8e-7, the
leaky ReLU 2.0e-6, the weight norm 1.8e-4, the convolutions 5.0e-3;
with PyTorch's oneDNN convolutions off the whole float32 run gives
4.3e-4 to 1.3e-3 (4 and 2 threads: the native conv's accumulation order
follows the threads), within twice JAX's error
(``test_hinge_gradient_gap_is_the_cpu_conv``).
The gradient is a difference of two nearly equal hinge means, which
magnifies whatever the conv backend's accumulation order rounds.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu.models import discriminators as jd
from ditsep_tpu_torch.models import discriminators as td
from ditsep_tpu_torch.models.weights import (
    disc_params_from_jax, disc_params_to_jax,
)
from test_torch_auraloss import grad_bar, jax_float64

N_FFTS = (2048, 1024, 512, 256, 128)  # the ldm config's
HOPS = (512, 256, 128, 64, 32)
T = 4096


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    """A JAX tree as a flat {"a/b/c": writable numpy array} dict."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def disc_pair(in_channels: int, filters: int = 8, n_ffts=N_FFTS, hops=HOPS):
    """(JAX module, its params, the port's module with the same weights);
    the JAX init's zero biases perturbed."""
    jdisc = jd.MultiScaleSTFTDiscriminator(
        filters=filters, n_ffts=n_ffts, hop_lengths=hops)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(in_channels),
                                 jnp.zeros((1, in_channels, T)))
    rng = np.random.default_rng(in_channels)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            if k.endswith("bias") else v
            for k, v in _flat(params["params"]).items()}
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    tdisc = td.MultiScaleSTFTDiscriminator(
        filters=filters, in_channels=in_channels, n_ffts=n_ffts,
        hop_lengths=hops)
    tdisc.load_state_dict(disc_params_from_jax(flat), strict=True)
    return jdisc, params, tdisc


@functools.lru_cache(maxsize=None)
def seeded_disc_pair(in_channels: int, filters: int = 4,
                     n_ffts=(256, 128), hops=(64, 32)):
    """As ``disc_pair``, without JAX's init (its tracing takes seconds):
    the port's seeded weights, biases perturbed, carried to JAX by
    ``disc_params_to_jax`` (the bridge is bit for bit both ways, above)."""
    tdisc = td.MultiScaleSTFTDiscriminator(
        filters=filters, in_channels=in_channels, n_ffts=n_ffts,
        hop_lengths=hops)
    tdisc.reset_parameters(torch.Generator().manual_seed(in_channels))
    rng = np.random.default_rng(in_channels)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            if k.endswith("bias") else v
            for k, v in disc_params_to_jax(tdisc).items()}
    tdisc.load_state_dict(disc_params_from_jax(flat), strict=True)
    jdisc = jd.MultiScaleSTFTDiscriminator(
        filters=filters, n_ffts=n_ffts, hop_lengths=hops)
    params = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return jdisc, params, tdisc


def _audio(b, c, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, c, T))
            ).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_bridge_both_ways_in_bits():
    _, params, tdisc = disc_pair(2)
    flat = _flat(params["params"])
    back = disc_params_to_jax(tdisc)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # with the collection wrapper too
    again = disc_params_from_jax({f"params/{k}": v for k, v in back.items()})
    for k, v in tdisc.state_dict().items():
        assert torch.equal(again[k], v), k
    assert tdisc.state_dict()["discs.0.convs.0.weight_v"].shape == (8, 4, 3, 9)


def test_seeded_init_follows_jax_init():
    """v ~ U(+-1/sqrt(fan_in)), g = ||v|| over all but the output axis,
    bias 0; the same seed gives the same weights."""
    a = td.MultiScaleSTFTDiscriminator(filters=8, n_ffts=(256,),
                                       hop_lengths=(64,))
    b = td.MultiScaleSTFTDiscriminator(filters=8, n_ffts=(256,),
                                       hop_lengths=(64,))
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    for m in a.modules():
        if isinstance(m, td.WNConv2d):
            v = m.weight_v
            bound = (v.shape[1] * v.shape[2] * v.shape[3]) ** -0.5
            assert v.abs().max() <= bound and v.abs().max() > 0.9 * bound
            assert torch.allclose(m.weight_g.flatten(),
                                  v.flatten(1).norm(dim=1), rtol=1e-6)
            assert not m.bias.any()


@pytest.mark.parametrize("in_channels", [1, 2])
def test_logits_and_feature_maps_match_jax(in_channels):
    jdisc, params, tdisc = disc_pair(in_channels)
    x = _audio(2, in_channels, seed=10 + in_channels)
    lj, fj = jax.jit(jdisc.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        lt, ft = tdisc(torch.from_numpy(x))
    assert len(lt) == len(lj) == 5 and len(ft) == 5
    for i in range(5):
        # JAX is NHWC (B, frames, bins, C); the port NCHW (B, C, frames,
        # bins)
        _close(lt[i], np.asarray(lj[i]).transpose(0, 3, 1, 2), 1e-5)
        assert len(ft[i]) == len(fj[i]) == 5
        for a, b in zip(ft[i], fj[i]):
            _close(a, np.asarray(b).transpose(0, 3, 1, 2), 1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_encodec_losses_match_jax(normalize):
    jdisc, params, tdisc = disc_pair(2)
    reals, fakes = _audio(2, 2, seed=20), _audio(2, 2, seed=21)
    want = jax.jit(lambda p, r, f: jd.encodec_discriminator_loss(
        jdisc, p, r, f, normalize_losses=normalize))(
        params, jnp.asarray(reals), jnp.asarray(fakes))
    with torch.no_grad():
        got = td.encodec_discriminator_loss(
            tdisc, torch.from_numpy(reals), torch.from_numpy(fakes),
            normalize_losses=normalize)
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w)), (g, w)


def _port_grads(tdisc, reals, fakes, dtype):
    """The port's gradients, float64 arrays: the generator's losses
    (adv + fm) w.r.t. the fakes, and the discriminator's loss w.r.t. its
    parameters."""
    named = dict(tdisc.named_parameters())
    r = torch.from_numpy(reals).to(dtype)
    f = torch.from_numpy(fakes).to(dtype).requires_grad_(True)
    _, adv, fm = td.encodec_discriminator_loss(tdisc, r, f)
    (g_fakes,) = torch.autograd.grad(adv + fm, [f])
    dis, _, _ = td.encodec_discriminator_loss(tdisc, r, f.detach())
    grads = torch.autograd.grad(dis, list(named.values()))
    return g_fakes.double().numpy(), {k: g.double().numpy()
                                      for k, g in zip(named, grads)}


_JAX_GRAD_FNS = {}


def _jax_grads(jdisc, params, reals, fakes):
    """JAX's gradients as ``_port_grads``'s, in the dtype of the inputs
    (float64 inside ``jax_float64``): one jitted function a
    discriminator, its inputs arguments (XLA folds captured float64
    constants for tens of seconds)."""
    if id(jdisc) not in _JAX_GRAD_FNS:
        def both(p, r, f):
            def gen(f):
                _, adv, fm = jd.encodec_discriminator_loss(jdisc, p, r, f)
                return adv + fm
            return jax.grad(gen)(f), jax.grad(
                lambda q: jd.encodec_discriminator_loss(jdisc, q, r, f)[0])(p)
        _JAX_GRAD_FNS[id(jdisc)] = jax.jit(both)
    dt = reals.dtype
    gf, gp = _JAX_GRAD_FNS[id(jdisc)](
        jax.tree.map(lambda a: jnp.asarray(a, dt), params),
        jnp.asarray(reals), jnp.asarray(fakes))
    return np.asarray(gf), {k: v.numpy() for k, v in disc_params_from_jax(
        {k: np.asarray(v) for k, v in _flat(gp["params"]).items()}).items()}


def test_encodec_loss_gradients_match_jax():
    """Both inputs noise of one scale: the float32 gradients at
    ``grad_bar``, the float64 ones against JAX's float64 run."""
    jdisc, params, tdisc = disc_pair(2)
    reals, fakes = _audio(2, 2, seed=30), _audio(2, 2, seed=31)
    gf_j, want = _jax_grads(jdisc, params, reals, fakes)
    with jax_float64():
        gf_j64, want64 = _jax_grads(jdisc, params, reals.astype(np.float64),
                                    fakes.astype(np.float64))
    assert gf_j64.dtype == np.float64
    gf_t, gp_t = _port_grads(tdisc, reals, fakes, torch.float32)
    gf_64, gp_64 = _port_grads(copy.deepcopy(tdisc).double(), reals, fakes,
                               torch.float64)
    assert gf_t.shape == gf_j.shape
    assert np.abs(gf_64 - gf_j64).max() <= 1e-6 * np.abs(gf_j64).max()
    assert np.abs(gf_t - gf_j).max() <= grad_bar(gf_j, gf_j64)
    assert set(want) == set(gp_t) == set(want64)
    top = max(np.abs(v).max() for v in want.values())
    for k, g in gp_t.items():
        assert np.abs(gp_64[k] - want64[k]).max() <= (
            1e-6 * np.abs(want64[k]).max()), k
        assert np.abs(g - want[k]).max() <= grad_bar(want[k], want64[k],
                                                     top), k


def test_encodec_loss_gradients_match_jax_fakes_apart():
    """Fakes at half the reals' amplitude, so that the hinge's real and
    fake means do not cancel: the discriminator's float32 gradients 1e-3
    of each leaf's max|ref|, nothing added. The fakes' gradient keeps
    ``grad_bar``: the feature matching's L1 takes the sign of near-equal
    features, which float32 flips."""
    jdisc, params, tdisc = disc_pair(2)
    reals, fakes = _audio(2, 2, seed=30), 0.5 * _audio(2, 2, seed=31)
    gf_j, want = _jax_grads(jdisc, params, reals, fakes)
    with jax_float64():
        gf_j64, _ = _jax_grads(jdisc, params, reals.astype(np.float64),
                               fakes.astype(np.float64))
    gf_t, gp_t = _port_grads(tdisc, reals, fakes, torch.float32)
    assert gf_t.shape == gf_j.shape
    assert np.abs(gf_t - gf_j).max() <= grad_bar(gf_j, gf_j64)
    assert set(want) == set(gp_t)
    for k, g in gp_t.items():
        assert np.abs(g - want[k]).max() <= 1e-3 * np.abs(want[k]).max(), k


def test_discriminator_loss_dispatch():
    _, _, tdisc = disc_pair(1, filters=4, n_ffts=(256,), hops=(64,))
    x = torch.from_numpy(_audio(1, 1, seed=40))
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(
            td.discriminator_loss(tdisc, x, 0.5 * x),
            td.encodec_discriminator_loss(tdisc, x, 0.5 * x)))
    with pytest.raises(TypeError, match="no discriminator family"):
        td.discriminator_loss(torch.nn.Conv1d(1, 1, 3), x, x)


def test_hinge_gradient_gap_is_the_cpu_conv():
    """With PyTorch's oneDNN convolutions off on the CPU, the port's
    float32 hinge gradient (fakes of the reals' scale) is off its float64
    one by at most twice JAX's own float32 error against JAX's float64
    run, the worst leaf as a share of its max: the gap is the conv
    backend's rounding (module docstring)."""
    jdisc, params, tdisc = disc_pair(2)
    reals, fakes = _audio(2, 2, seed=30), _audio(2, 2, seed=31)
    _, want = _jax_grads(jdisc, params, reals, fakes)
    with jax_float64():
        _, want64 = _jax_grads(jdisc, params, reals.astype(np.float64),
                               fakes.astype(np.float64))
    _, g64 = _port_grads(copy.deepcopy(tdisc).double(), reals, fakes,
                         torch.float64)
    with torch.backends.mkldnn.flags(enabled=False):
        _, g32 = _port_grads(tdisc, reals, fakes, torch.float32)
    assert _worst(g32, g64)[0] <= 2 * _worst(want, want64)[0]


def _worst(g, g64):
    """The largest distance over the leaves, as a share of each leaf's
    max, and its leaf."""
    return max((np.abs(g[k] - v).max() / np.abs(v).max(), k)
               for k, v in g64.items() if np.abs(v).max() > 0)


def _float32_stage(stage: str):
    """The float64 loss with one stage computed in float32 (its inputs
    rounded, its output widened): (object, attribute, value) patches."""
    import torch.nn.functional as F
    stft, lrelu = td.stft_fn, F.leaky_relu

    def conv(self, x):
        dt = torch.float32 if stage == "conv" else torch.float64
        wdt = torch.float32 if stage == "weight_norm" else torch.float64
        v = self.weight_v.to(wdt)
        norm = torch.sqrt((v ** 2).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        w = (v / norm * self.weight_g.to(wdt)).to(dt)
        return F.conv2d(x.to(dt), w, self.bias.to(dt), stride=self.stride,
                        padding=self.padding,
                        dilation=self.dilation).double()

    if stage == "stft":
        return td, "stft_fn", lambda x, **kw: stft(x.float(), **kw).to(
            torch.complex128)
    if stage == "leaky_relu":
        return F, "leaky_relu", lambda x, s: lrelu(x.float(), s).double()
    return td.WNConv2d, "forward", conv


def main():
    """Print the hinge loss's gradients w.r.t. the discriminator's
    parameters (the tests' inputs: fakes of the reals' scale, then at
    half their amplitude), float32 against JAX's own float64 run: the
    largest distance over the leaves as a share of each leaf's max,
    JAX's and the port's (PERF.md's parity table); then the port's
    float64 run with one stage in float32 at a time, and its float32 run
    with PyTorch's oneDNN convolutions off (the module docstring):

        JAX_PLATFORMS=cpu PYTHONPATH=. python \
            tests/test_torch_discriminators.py
    """
    jdisc, params, tdisc = disc_pair(2)
    reals = _audio(2, 2, seed=30)
    for scale in (1.0, 0.5):
        fakes = scale * _audio(2, 2, seed=31)
        _, want = _jax_grads(jdisc, params, reals, fakes)
        with jax_float64():
            _, g64 = _jax_grads(jdisc, params, reals.astype(np.float64),
                                fakes.astype(np.float64))
        _, g32 = _port_grads(tdisc, reals, fakes, torch.float32)
        for name, g in (("JAX", want), ("port", g32)):
            worst = _worst(g, g64)
            print(f"fakes x{scale} {name}: {worst[0]:.2e} of the leaf's "
                  f"max ({worst[1]})")
        _, p64 = _port_grads(copy.deepcopy(tdisc).double(), reals, fakes,
                             torch.float64)
        for stage in ("stft", "weight_norm", "conv", "leaky_relu"):
            obj, attr, value = _float32_stage(stage)
            saved = getattr(obj, attr)
            setattr(obj, attr, value)
            try:
                _, g = _port_grads(copy.deepcopy(tdisc).double(), reals,
                                   fakes, torch.float64)
            finally:
                setattr(obj, attr, saved)
            print(f"fakes x{scale} port float64, {stage} in float32: "
                  f"{_worst(g, p64)[0]:.2e}")
        with torch.backends.mkldnn.flags(enabled=False):
            _, g = _port_grads(tdisc, reals, fakes, torch.float32)
        print(f"fakes x{scale} port float32, oneDNN convs off: "
              f"{_worst(g, p64)[0]:.2e}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    main()
