"""The port's spectral losses, its window-normalized STFT, the inverse-LR
schedule and the AdamW chain of the LDM and VAE-GAN trainers against the
JAX package's on the CPU, with inputs made by numpy from a seed.

Tolerances, stated before the runs: ``stft(normalized=True)`` 1e-5 of
max|ref| (center=False at the discriminator's sizes); the A-weighting
taps bit for bit; ``fir_prefilter`` 1e-6 abs; ``stft_loss`` (each term
and option) and the MRSTFT at the ldm config's 7 resolutions, perceptual
weighting on and off, 1e-4 of |ref|, their gradients w.r.t. the estimate
1e-3 of max|ref| plus twice JAX's own float32 error against JAX's own
float64 run (``grad_bar``, ``jax_float64``), and the port's float64
gradient 1e-6 of max|ref| of JAX's float64 one;
``pit_min`` the same permutation as JAX and its loss 1e-4 of |ref|;
L1 / MSE 1e-6 of |ref|; ``inverse_lr_schedule`` 1e-7 relative at steps
0, 1, 10 and 1000; three ``ClipAdamW`` updates against
optax's chain (clip on and off) 1e-5 of the largest parameter change.
"""
import contextlib
import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ditsep_tpu.ops import stft as jax_stft
from ditsep_tpu.training import auraloss as ja
from ditsep_tpu.training.schedules import (
    inverse_lr_schedule as jax_schedule,
)
from ditsep_tpu_torch.ops.stft import stft as torch_stft
from ditsep_tpu_torch.training import auraloss as ta
from ditsep_tpu_torch.training.schedules import (
    ClipAdamW, inverse_lr_schedule,
)

FFT_SIZES = (2048, 1024, 512, 256, 128, 64, 32)  # the ldm config's
HOP_SIZES = (512, 256, 128, 64, 32, 16, 8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed):
    """An estimate and a target near it, float32."""
    rng = np.random.default_rng(seed)
    y = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    x = (y + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return x, y


def _loss_and_grad_jax(fn, x, y):
    """Jitted: JAX's eager first call compiles op by op (20 s for the 7
    resolutions)."""
    val, g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(x), jnp.asarray(y))
    return float(val), np.asarray(g)


def _loss_and_grad_torch(fn, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    val = fn(xt, torch.from_numpy(y))
    (g,) = torch.autograd.grad(val, [xt])
    return val.item(), g.numpy()


class _Float64Jnp:
    """``jax.numpy`` as the JAX package's STFT and discriminator see it in
    their float64 run: the explicit float32 of the STFT's output and of
    the weight norm is float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _stft_bases_f64(n_fft: int, window_key: str = "hann"):
    """The JAX STFT's windowed DFT bases and window, kept in float64."""
    mod = sys.modules["ditsep_tpu.ops.stft"]
    win = mod.hann_window(n_fft)
    cos_b, msin_b = mod._dft_bases(n_fft)
    return win[:, None] * cos_b, win[:, None] * msin_b, win


@contextlib.contextmanager
def jax_float64():
    """JAX's own float64 run (``jax.enable_x64``, inputs and parameters
    made float64 by the caller): the STFT's bases and its and the weight
    norm's float32 casts widened (the A-weighting taps stay JAX's
    float32 ones, as in the port). It is the witness of JAX's float32
    error."""
    stft_mod = sys.modules["ditsep_tpu.ops.stft"]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as m:
        for mod in (stft_mod,
                    sys.modules["ditsep_tpu.models.discriminators"]):
            m.setattr(mod, "jnp", _Float64Jnp())
        m.setattr(stft_mod, "_stft_bases", _stft_bases_f64)
        yield


def grad_bar(g_jax, g_jax64, top=None) -> float:
    """The gradient bar: 1e-3 of max|ref| (with ``top``, the largest
    |ref| of all of a model's leaves, at least 1e-4 of it) plus twice
    JAX's own float32 error, its largest distance from JAX's float64
    gradient (``jax_float64``). The perceptual log magnitude and the
    discriminator's hinge between inputs of one scale are
    ill-conditioned in float32: their JAX gradients lie up to 1.7e-3 of
    max and 8.9e-4 of a leaf's max off float64, the port's up to 1.7e-3
    and 5.7e-3 (``main`` below and tests/test_torch_discriminators.py's)."""
    bar = 1e-3 * np.abs(g_jax).max()
    if top is not None:
        bar = max(bar, 1e-4 * top)
    return bar + 2 * np.abs(g_jax - g_jax64).max()


def _check_loss_and_grad(jfn, tfn, x, y):
    """The loss (float32, and float64 for the reference) against JAX's;
    the float32 gradient against JAX's at ``grad_bar``, and the port's
    float64 gradient against JAX's float64 one at 1e-6 of its max."""
    lj, gj = _loss_and_grad_jax(jfn, x, y)
    with jax_float64():
        lj64, gj64 = _loss_and_grad_jax(jfn, x.astype(np.float64),
                                        y.astype(np.float64))
    assert gj64.dtype == np.float64
    lt, gt = _loss_and_grad_torch(tfn, x, y)
    l64, g64 = _loss_and_grad_torch(tfn, x.astype(np.float64),
                                    y.astype(np.float64))
    assert abs(lt - lj) <= 1e-4 * abs(lj), (lt, lj)
    assert abs(l64 - lj64) <= 1e-6 * abs(lj64), (l64, lj64)
    assert np.abs(g64 - gj64).max() <= 1e-6 * np.abs(gj64).max()
    assert np.abs(gt - gj).max() <= grad_bar(gj, gj64)


@pytest.mark.parametrize("n_fft,hop,center", [
    *((n, h, False) for n, h in zip(FFT_SIZES[:5], HOP_SIZES[:5])),
    (510, 128, True)])
def test_stft_normalized_matches_jax(n_fft, hop, center):
    x, _ = _pair((2, 2, 4500), seed=n_fft)
    want = np.asarray(jax_stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop,
                               center=center, normalized=True))
    got = torch_stft(torch.from_numpy(x), n_fft, hop, center=center,
                     normalized=True).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_stft_without_center_refuses_a_short_signal():
    with pytest.raises(ValueError, match="n_fft"):
        torch_stft(torch.zeros(1, 100), 128, 32, center=False)


def test_a_weighting_taps_and_prefilter_match_jax():
    taps = ta.a_weighting_fir(8000)
    want_taps = ja.a_weighting_fir(8000)
    assert taps.dtype == np.float32 and taps.shape == (101,)
    assert np.array_equal(taps, want_taps)
    x, _ = _pair((2, 3, 700), seed=1)
    want = np.asarray(ja.fir_prefilter(jnp.asarray(x), want_taps))
    got = ta.fir_prefilter(torch.from_numpy(x), taps).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


STFT_LOSS_OPTIONS = {
    "default": {},
    "lin_mag": {"w_lin_mag": 1.0},
    "sc_only": {"w_log_mag": 0.0},
    "log_mag_only": {"w_sc": 0.0},
    "scale_invariance": {"scale_invariance": True, "w_lin_mag": 0.5},
    "perceptual": {"perceptual_weighting": True, "sample_rate": 8000},
}


@pytest.mark.parametrize("name", sorted(STFT_LOSS_OPTIONS))
def test_stft_loss_and_gradient_match_jax(name):
    kw = dict(fft_size=256, hop_size=64, **STFT_LOSS_OPTIONS[name])
    x, y = _pair((2, 2, 1500), seed=2)
    _check_loss_and_grad(lambda a, b: ja.stft_loss(a, b, **kw),
                         lambda a, b: ta.stft_loss(a, b, **kw), x, y)


@pytest.mark.parametrize("perceptual", [False, True])
def test_mrstft_and_gradient_match_jax(perceptual):
    kw = dict(fft_sizes=FFT_SIZES, hop_sizes=HOP_SIZES, sample_rate=8000,
              perceptual_weighting=perceptual)
    x, y = _pair((2, 2, 3000), seed=3)
    _check_loss_and_grad(
        lambda a, b: ja.multi_resolution_stft_loss(a, b, **kw),
        lambda a, b: ta.multi_resolution_stft_loss(a, b, **kw), x, y)


@pytest.mark.parametrize("loss", ["l1", "mrstft"])
def test_pit_min_chooses_jax_permutation(loss):
    """Sources swapped in the estimate: both pick the swap back, and the
    minimum is JAX's."""
    x, y = _pair((3, 2, 1024), seed=4)
    x = np.ascontiguousarray(x[:, ::-1])
    kw = dict(fft_sizes=(256, 64), hop_sizes=(64, 16))
    jfn = (ja.l1_loss if loss == "l1" else
           lambda a, b: ja.multi_resolution_stft_loss(a, b, **kw))
    tfn = (ta.l1_loss if loss == "l1" else
           lambda a, b: ta.multi_resolution_stft_loss(a, b, **kw))
    perms = list(itertools.permutations(range(2)))
    per_j = [float(jfn(jnp.asarray(x[:, list(p)]), jnp.asarray(y)))
             for p in perms]
    per_t = [tfn(torch.from_numpy(x[:, list(p)]), torch.from_numpy(y)).item()
             for p in perms]
    assert int(np.argmin(per_t)) == int(np.argmin(per_j)) == 1
    want = float(ja.pit_min(jfn, jnp.asarray(x), jnp.asarray(y)))
    got = ta.pit_min(tfn, torch.from_numpy(x), torch.from_numpy(y)).item()
    assert want == min(per_j)
    assert abs(got - want) <= 1e-4 * abs(want)


def test_l1_and_mse_match_jax():
    x, y = _pair((2, 2, 500), seed=5)
    for jfn, tfn in ((ja.l1_loss, ta.l1_loss), (ja.mse_loss, ta.mse_loss)):
        want = float(jfn(jnp.asarray(x), jnp.asarray(y)))
        got = tfn(torch.from_numpy(x), torch.from_numpy(y)).item()
        assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("step", [0, 1, 10, 1000])
def test_inverse_lr_schedule_matches_jax(step):
    for base, kw in ((1.5e-4, {}), (3e-4, {}),
                     (1e-3, dict(inv_gamma=100.0, power=0.7, warmup=0.9))):
        want = float(jax_schedule(base, **kw)(jnp.asarray(step, jnp.int32)))
        got = inverse_lr_schedule(base, **kw)(step)
        assert abs(got - want) <= 1e-7 * want, (base, kw, got, want)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_clip_adamw_matches_optax(clip):
    """Three updates of random gradients: the rate of update n is the
    schedule at n (LambdaLR), the parameters optax's."""
    rng = np.random.default_rng(6)
    lr = 100.0  # the warmup's first rates are 1e-3 lr: steps near 0.1
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in (("a", (3, 4)), ("b", (5,)))}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(jax_schedule(lr), b1=0.8, b2=0.99, weight_decay=1e-3)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(pj)
    params = [torch.from_numpy(p0[k].copy()) for k in ("a", "b")]
    opt = ClipAdamW(params, lr, clip=clip)
    rate = inverse_lr_schedule(lr)
    for n, g in enumerate(grads):
        assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(rate(n),
                                                                rel=1e-12)
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        assert opt.count == n + 1
        for k, p in zip(("a", "b"), params):
            moved = np.abs(np.asarray(pj[k]) - p0[k]).max()
            np.testing.assert_allclose(p.numpy(), np.asarray(pj[k]), rtol=0,
                                       atol=1e-5 * moved)
    state = opt.state_dict()
    again = ClipAdamW([p.clone() for p in params], lr, clip=clip)
    again.load_state_dict(state)
    assert again.count == 3


def main():
    """Print, for the perceptual MRSTFT at the ldm config's 7 resolutions
    (seeds 3-5, the size of the test above), each float32 gradient's
    largest distance from JAX's own float64 one (``jax_float64``), as a
    share of its max: JAX's, the port's, and the port's with its
    prefilter convolved in float32 (PERF.md's parity table):

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_auraloss.py
    """
    import torch.nn.functional as F
    kw = dict(fft_sizes=FFT_SIZES, hop_sizes=HOP_SIZES, sample_rate=8000,
              perceptual_weighting=True)
    loss_j = lambda a, b: ja.multi_resolution_stft_loss(a, b, **kw)  # noqa
    loss_t = lambda a, b: ta.multi_resolution_stft_loss(a, b, **kw)  # noqa
    real = ta.fir_prefilter

    def prefilter_f32(x, taps):
        w = torch.as_tensor(np.ascontiguousarray(taps[::-1])).view(1, 1, -1)
        y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w.to(x.dtype),
                     padding=len(taps) // 2)
        return y.reshape(x.shape[:-1] + y.shape[-1:])

    for seed in (3, 4, 5):
        x, y = _pair((2, 2, 3000), seed=seed)
        with jax_float64():
            _, g64 = _loss_and_grad_jax(loss_j, x.astype(np.float64),
                                        y.astype(np.float64))
        top = np.abs(g64).max()
        _, gj = _loss_and_grad_jax(loss_j, x, y)
        _, gt = _loss_and_grad_torch(loss_t, x, y)
        ta.fir_prefilter = prefilter_f32
        try:
            _, gf = _loss_and_grad_torch(loss_t, x, y)
        finally:
            ta.fir_prefilter = real
        print(f"seed {seed}: float32 gradient vs float64, share of max: "
              f"JAX {np.abs(gj - g64).max() / top:.2e}, port "
              f"{np.abs(gt - g64).max() / top:.2e}, port with a float32 "
              f"prefilter {np.abs(gf - g64).max() / top:.2e}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    main()
