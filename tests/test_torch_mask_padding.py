"""The port's masked scoring (``mask_padding`` and per-item ``lengths``)
against the JAX package's, on the CPU: ``pool_time_mask`` (exact), the
masked GroupNorm against flax's ``GroupNorm(mask=...)`` (1e-5 abs), the
masked attention block (2e-5 * max|ref|), NCSN++ with a static and a
per-item mask (2e-5 * max|ref|), the score model with ``lengths`` (1e-4 *
max|ref|), ``normalize_batch(lengths=)`` (1e-5 abs, the tail exactly 0),
``separate(lengths=)`` and ``separate_minibatched`` with matched noise
(1e-3 * max|ref|), and the port's own padding invariance. The masked
train step is tests/test_torch_mask_padding_train.py. Tolerances stated
before the runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.models import NCSNpp as JaxNCSNpp
from ditsep_tpu.models import layers as JL
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.models import NCSNpp, ScoreModelNCSNpp, params_from_jax
from ditsep_tpu_torch.models import layers as L
from ditsep_tpu_torch.utils.separate import normalize_batch
from test_torch_train import TINY

MASKED = {**TINY, "model.score_model.mask_padding": True}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(params, seed):
    """JAX params with every leaf perturbed (the zero-scaled init hides
    whole branches): the flat numpy dict and the tree."""
    rng = np.random.default_rng(seed)
    flat = {k: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
            for k, a in _flat(params).items()}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                           for k, a in flat.items()})
    return flat, tree


def _close(got, want, bar):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)


@pytest.mark.parametrize("width", [1, 2, 5, 8, 13, 64])
def test_pool_time_mask_matches_jax(width):
    rng = np.random.default_rng(width)
    m = rng.random((3, width)) < 0.6
    m[0] = np.arange(width) < (width + 1) // 2  # a valid prefix, as lengths
    want = np.asarray(JL.pool_time_mask(jnp.asarray(m)))
    got = L.pool_time_mask(torch.from_numpy(m))
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _tmask(valid, width):
    return np.arange(width)[None, :] < np.asarray(valid)[:, None]


@pytest.mark.parametrize("valid", [(7, 10), (10, 10), (1, 4)])
def test_masked_group_norm_matches_flax(valid):
    b, c, h, w = 2, 32, 6, 10
    rng = np.random.default_rng(sum(valid))
    x = (3.0 * rng.standard_normal((b, h, w, c)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    tm = _tmask(valid, w)
    gn = JL.group_norm(c)
    want = gn.apply({"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}},
                    jnp.asarray(x),
                    mask=JL.time_mask_to_gn(jnp.asarray(tm), x))
    port = L.group_norm(c)
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
               L.time_mask_to_gn(torch.from_numpy(tm)))
    _close(got.permute(0, 2, 3, 1), want, 1e-5)
    # no mask: the unmasked kernel, as before
    unmasked = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(unmasked.permute(0, 2, 3, 1),
           gn.apply({"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}},
                    jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("shape,groups,plain", [
    ((1, 4, 70000), 1, True),     # one row of 280,000 values
    ((2, 64, 8, 9), 32, False),   # 64 short rows
    ((1, 32, 5, 7), 8, False),    # few rows, short
])
def test_unmasked_group_norm_matches_flax_both_ways(monkeypatch, shape,
                                                   groups, plain):
    """Unmasked, the port's GroupNorm takes plain reductions for a few
    long rows and ``F.group_norm`` otherwise; both give flax's
    ``GroupNorm`` (channels last there) within 1e-5 abs."""
    import flax.linen as fnn
    rng = np.random.default_rng(groups)
    x = (3.0 * rng.standard_normal(shape) + 1.5).astype(np.float32)
    c = shape[1]
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    last = np.moveaxis(x, 1, -1)
    want = fnn.GroupNorm(num_groups=groups, epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(last))
    port = L.GroupNorm(groups, c, 1e-6)
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    library = []
    real = L.F.group_norm
    monkeypatch.setattr(L.F, "group_norm",
                        lambda *a, **k: library.append(1) or real(*a, **k))
    got = port(torch.from_numpy(x))
    assert bool(library) is not plain
    _close(got.movedim(1, -1), want, 1e-5)


def test_masked_attention_matches_jax():
    b, c, h, w = 2, 16, 4, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    tm = _tmask((5, 8), w)
    jm = JL.AttnBlockpp(skip_rescale=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat, tree = _perturbed(params, 4)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x),
                               tmask=jnp.asarray(tm)))
    port = L.AttnBlockpp(c, skip_rescale=True).eval()
    port.load_state_dict(params_from_jax(flat), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   tmask=torch.from_numpy(tm)).permute(0, 2, 3, 1)
    _close(got, want, 2e-5 * np.abs(want).max())
    # the mask matters: invalid keys take no weight
    with torch.no_grad():
        free = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (free.permute(0, 2, 3, 1).numpy() - want).__abs__().max() > 1e-3


NCSN_CFG = dict(nf=16, ch_mult=(1, 1), num_res_blocks=1,
                attn_resolutions=(16,), image_size=32, num_channels_in=6,
                num_channels_out=4)


@pytest.mark.parametrize("mode", ["static", "per_item"])
def test_masked_ncsnpp_matches_jax(mode):
    b, h, w = 2, 32, 16
    rng = np.random.default_rng(5)
    jm = JaxNCSNpp(**NCSN_CFG)
    x = rng.standard_normal((b, h, w, 6)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(t))["params"]
    flat, tree = _perturbed(params, 6)
    tm = _tmask((11, 11) if mode == "static" else (11, 16), w)
    want = np.asarray(jax.jit(jm.apply)(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t),
        time_mask=jnp.asarray(tm)))
    port = NCSNpp(**NCSN_CFG).eval()
    port.load_state_dict(params_from_jax(flat), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                   torch.from_numpy(t), time_mask=torch.from_numpy(tm))
    _close(got.permute(0, 2, 3, 1), want, 2e-5 * np.abs(want).max())


def _masked_pair(length, seed=2):
    """The JAX and port trainers on the tiny masked config, with the same
    (JAX-initialised, perturbed) weights."""
    jt = jax_build(jax_override(jax_diffsep(), MASKED))
    tt = build_diffsep_trainer(override(diffsep(), MASKED), device="cpu")
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, length)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, length)))
    flat, tree = _perturbed(tmpl["params"], seed)
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, {"params": tree}, tt


@pytest.fixture(scope="module")
def masked_pair():
    return _masked_pair(1200)


def test_masked_score_model_with_lengths_matches_jax(masked_pair):
    jt, params, tt = masked_pair
    rng = np.random.default_rng(7)
    xt = rng.standard_normal((2, 2, 1200)).astype(np.float32)
    mix = rng.standard_normal((2, 1, 1200)).astype(np.float32)
    t = np.array([0.4, 0.9], np.float32)
    for lens in (None, np.array([700, 1200], np.int32)):
        kw = {} if lens is None else {"lengths": jnp.asarray(lens)}
        want = np.asarray(jax.jit(lambda p, a, b, c: jt.model.apply(
            p, a, b, c, **kw))(params, jnp.asarray(xt), jnp.asarray(t),
                               jnp.asarray(mix)))
        tkw = {} if lens is None else {"lengths": torch.from_numpy(lens)}
        with torch.no_grad():
            got = tt.model(torch.from_numpy(xt), torch.from_numpy(t),
                           torch.from_numpy(mix), **tkw)
        _close(got, want, 1e-4 * np.abs(want).max())


def test_normalize_batch_with_lengths_matches_jax():
    from ditsep_tpu.utils.separate import normalize_batch as jax_normalize
    rng = np.random.default_rng(8)
    mix = rng.standard_normal((4, 1, 300)).astype(np.float32) + 0.3
    tgt = rng.standard_normal((4, 2, 300)).astype(np.float32)
    lens = np.array([300, 120, 1, 0], np.int32)  # a single and no sample
    (jm, jt), jmean, jstd = jax_normalize(
        (jnp.asarray(mix), jnp.asarray(tgt)), lengths=jnp.asarray(lens))
    (m, t), mean, std = normalize_batch(
        (torch.from_numpy(mix), torch.from_numpy(tgt)),
        lengths=torch.from_numpy(lens))
    for a, b in ((m, jm), (t, jt), (mean, jmean), (std, jstd)):
        _close(a, b, 1e-5)
    for i, n in enumerate(lens):
        assert (m[i, :, n:] == 0).all() and (t[i, :, n:] == 0).all()


def _noise(rng, b, length, n):
    return (rng.standard_normal((b, 2, length)).astype(np.float32),
            rng.standard_normal((n, 1, b, 2, length)).astype(np.float32),
            rng.standard_normal((n, b, 2, length)).astype(np.float32))


N_STEPS = 2


@pytest.fixture(scope="module")
def jax_separate(masked_pair):
    """JAX's separate(lengths=) at N=2 with explicit noise, jitted once."""
    jt, params, _ = masked_pair
    fn = jax.jit(lambda p, m, lens, noise: jt.separate(
        p, jax.random.PRNGKey(0), m, N=N_STEPS, lengths=lens, noise=noise))
    return lambda mix, lens, noise: fn(params, jnp.asarray(mix),
                                       jnp.asarray(lens), noise)


def test_separate_with_lengths_matches_jax(masked_pair, jax_separate):
    _, _, tt = masked_pair
    b, length = 2, 1200
    rng = np.random.default_rng(9)
    mix = (0.1 * rng.standard_normal((b, 1, length))).astype(np.float32)
    lens = np.array([900, 1200], np.int32)
    mix[0, :, 900:] = 0.0
    noise = _noise(rng, b, length, N_STEPS)
    want, nfe_j = jax_separate(mix, lens, noise)
    got, nfe_t = tt.separate(torch.from_numpy(mix), N=N_STEPS,
                             lengths=torch.from_numpy(lens), noise=noise)
    assert nfe_t == int(nfe_j) == 2 * N_STEPS
    _close(got, want, 1e-3 * np.abs(np.asarray(want)).max())


def test_separate_minibatched_matches_unbatched_calls(masked_pair,
                                                      jax_separate):
    """5 items in chunks of 2 equal 3 unbatched calls of JAX's separate
    (the last on item 4 repeated; full lengths are the static mask), each
    chunk with the same noise; with per-item lengths, 3 unbatched calls of
    the port's own, each given its chunk's lengths."""
    _, _, tt = masked_pair
    b, length, chunk = 5, 1200, 2
    rng = np.random.default_rng(10)
    mix = (0.1 * rng.standard_normal((b, 1, length))).astype(np.float32)
    noise = _noise(rng, chunk, length, N_STEPS)
    got, nfe = tt.separate_minibatched(torch.from_numpy(mix),
                                       max_batch=chunk, N=N_STEPS,
                                       noise=noise)
    lens = torch.tensor([1200, 800, 1000, 600, 900])
    got_l, _ = tt.separate_minibatched(torch.from_numpy(mix), lengths=lens,
                                       max_batch=chunk, N=N_STEPS,
                                       noise=noise)
    assert nfe == 2 * N_STEPS and got.shape == (b, 2, length)
    want, want_l = [], []
    for s in (0, 2, 4):
        m, ln = mix[s:s + chunk], lens[s:s + chunk]
        if m.shape[0] < chunk:
            m, ln = np.concatenate([m, m[-1:]]), torch.cat([ln, ln[-1:]])
        k = min(chunk, b - s)
        want.append(np.asarray(jax_separate(
            m, np.full(chunk, length, np.int32), noise)[0])[:k])
        want_l.append(tt.separate(torch.from_numpy(m), N=N_STEPS,
                                  noise=noise, lengths=ln)[0][:k].numpy())
    want = np.concatenate(want)
    _close(got, want, 1e-3 * np.abs(want).max())
    want_l = np.concatenate(want_l)
    _close(got_l, want_l, 1e-3 * np.abs(want_l).max())


# the JAX package's invariance test (tests/test_mask_padding.py:32) on the
# port: F = n_fft//2+1 = 32 = image_size
KW = dict(num_sources=2, n_fft=62, hop_length=16, nf=8, ch_mult=(1, 1),
          num_res_blocks=1, attn_resolutions=(16,), image_size=32)


def _seeded(mask_padding):
    model = ScoreModelNCSNpp(mask_padding=mask_padding, **KW).eval()
    g = torch.Generator().manual_seed(1)
    model.backbone.reset_parameters(g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.mark.parametrize("padded", [1900, 2600], ids=["inside_block",
                                                      "past_block"])
def test_masked_forward_is_padding_invariant(padded):
    """1600 samples fill 103 of 128 frames; 1900 stay inside that block,
    2600 cross into a third (192 frames). A masked forward with lengths
    equals the native one on the valid region within 1e-3 relative (a
    margin for the convs' and iSTFT's reach); past the block, the unmasked
    one diverges at least 10x more."""
    n1 = 1600
    g = torch.Generator().manual_seed(0)
    xt, mix = torch.randn(2, 2, n1, generator=g), torch.randn(2, 1, n1,
                                                              generator=g)
    t = torch.tensor([0.4, 0.8])
    lens = torch.tensor([n1, n1])
    pad = (0, padded - n1)
    inner = slice(0, n1 - 8 * 16)

    def rel(model, **kw):
        with torch.no_grad():
            a = model(xt, t, mix, **kw)[..., inner]
            b = model(torch.nn.functional.pad(xt, pad), t,
                      torch.nn.functional.pad(mix, pad), **kw)[..., inner]
        return ((a - b).abs().max() / (a.abs().max() + 1e-9)).item()

    r_masked = rel(_seeded(True), lengths=lens)
    assert r_masked < 1e-3
    if padded == 2600:
        assert rel(_seeded(False)) > 10 * r_masked
