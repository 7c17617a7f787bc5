"""The port's normalization layers and alternative backbones
(models/normalization.py, models/backbones.py) against the JAX package's
on the CPU, the same seeded weights through ``params_from_jax`` and the same
inputs: the norms 1e-5 abs (ops), the TCN, DPTNet (LSTM and GRU,
bidirectional, a ragged length) and DiffuSE 1e-4 max|ref| (model
forwards). The JAX side is jitted with the weights as arguments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import init_shapes, load_jax, redraw

from ditsep_tpu.models import backbones as jb
from ditsep_tpu.models import normalization as jn
from ditsep_tpu_torch.models import backbones as tb
from ditsep_tpu_torch.models import normalization as tn

OPS_TOL = 1e-5      # abs, ops
MODEL_TOL = 1e-4    # of max|ref|, model forwards


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_apply(module, tree, *args):
    return np.asarray(jax.jit(module.apply)(tree, *args))


def _close(got, want, tol, rel=True):
    got = got.detach().numpy()
    bar = tol * (np.abs(want).max() if rel else 1.0)
    err = np.abs(got - want).max()
    assert got.shape == want.shape
    assert err <= bar, f"max err {err:.3g} over the bar {bar:.3g}"


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["cLN", "gLN", "BN"])
def test_choose_norm_matches_jax(kind):
    x = _rand((3, 7, 6), 0, 2.0) + 0.5
    jm = jn.choose_norm(kind, 6)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 1)
    tm = load_jax(tn.choose_norm(kind, 6), tree)
    _close(tm(torch.from_numpy(x)), _jax_apply(jm, tree, x), OPS_TOL, False)


@pytest.mark.parametrize("bias", [True, False])
def test_instance_norms_match_jax(bias):
    """NHWC in JAX, NCHW in the port."""
    x = _rand((2, 5, 6, 4), 2, 1.5)
    y = np.array([3, 1], np.int32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    jm = jn.ConditionalInstanceNorm2dPlus(num_classes=5, bias=bias)
    tree = redraw(init_shapes(jm, jnp.asarray(x), jnp.asarray(y)), 3)
    tm = load_jax(tn.get_normalization(conditional=True, num_classes=5)(
        4, bias=bias), tree)
    _close(tm(xt, torch.from_numpy(y).long()).permute(0, 2, 3, 1),
           _jax_apply(jm, tree, x, y), OPS_TOL, False)
    jm = jn.InstanceNorm2dPlus(bias=bias)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 4)
    tm = load_jax(tn.get_normalization()(4, bias=bias), tree)
    _close(tm(xt).permute(0, 2, 3, 1), _jax_apply(jm, tree, x), OPS_TOL,
           False)


def test_get_normalization_groupnorm_and_refusals():
    x = _rand((2, 3, 5, 8), 5)
    jm = jn.get_normalization("GroupNorm")(num_groups=2, epsilon=1e-5)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 6)
    tm = load_jax(tn.get_normalization("GroupNorm")(8, num_groups=2,
                                                    epsilon=1e-5), tree)
    _close(tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           _jax_apply(jm, tree, x), OPS_TOL, False)
    with pytest.raises(NotImplementedError):
        tn.get_normalization("BatchNorm")
    with pytest.raises(ValueError, match="norm type"):
        tn.choose_norm("xLN", 4)


@pytest.mark.parametrize("nonlinear,norm", [("relu", "gLN"),
                                            ("softmax", "cLN"),
                                            ("sigmoid", "BN"),
                                            ("tanh", "gLN")])
def test_temporal_conv_net_matches_jax(nonlinear, norm):
    cfg = dict(N=16, B=8, H=12, P=3, X=3, R=2, C=2, norm_type=norm,
               mask_nonlinear=nonlinear)
    w = _rand((2, 16, 37), 7)
    jm = jb.TemporalConvNet(**cfg)
    tree = redraw(init_shapes(jm, jnp.asarray(w)), 8)
    tm = load_jax(tb.TemporalConvNet(**cfg), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(w))
    _close(got, _jax_apply(jm, tree, w), MODEL_TOL)
    with pytest.raises(ValueError, match="non-linear"):
        tb.TemporalConvNet(mask_nonlinear="gelu")


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
@pytest.mark.parametrize("t", [40, 33])  # a multiple of the chunk, ragged
def test_dptnet_matches_jax(rnn, t):
    x = _rand((2, 8, t), 9)
    cfg = dict(hidden_size=6, att_heads=2, num_layers=2, chunk_size=10,
               rnn_type=rnn)
    jm = jb.DPTNet(output_size=5, **cfg)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 10)
    tm = load_jax(tb.DPTNet(8, 5, **cfg), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, _jax_apply(jm, tree, x), MODEL_TOL)


@pytest.mark.parametrize("rnn,bidirectional", [("lstm", False),
                                               ("gru", True)])
def test_transformer_layer_matches_jax(rnn, bidirectional):
    x = _rand((3, 11, 8), 11)
    kw = dict(att_heads=4, hidden_size=5, rnn_type=rnn,
              bidirectional=bidirectional, norm="cLN")
    jm = jb.ImprovedTransformerLayer(**kw)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 12)
    tm = load_jax(tb.ImprovedTransformerLayer(8, **kw), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, _jax_apply(jm, tree, x), MODEL_TOL)


def test_diffuse_matches_jax():
    """Steps between table rows (the lerp) and past its end (clamped)."""
    cfg = dict(residual_channels=8, residual_layers=4,
               dilation_cycle_length=2, max_steps=50)
    xt, cond = _rand((3, 1, 50), 13), _rand((3, 1, 50), 14)
    t = np.array([0.013, 0.5, 1.2], np.float32)
    jm = jb.DiffuSE(**cfg)
    tree = redraw(init_shapes(jm, jnp.asarray(xt), jnp.asarray(t),
                              jnp.asarray(cond)), 15)
    tm = load_jax(tb.DiffuSE(**cfg), tree)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (xt, t, cond)))
    _close(got, _jax_apply(jm, tree, xt, t, cond), MODEL_TOL)


def test_seeded_init_is_reproducible():
    """A generator re-initialises every parameter; two seeds differ."""
    def draw(seed):
        m = tb.DPTNet(8, 5, hidden_size=6, att_heads=2, num_layers=1,
                      chunk_size=10, rnn_type="gru")
        m.reset_parameters(torch.Generator().manual_seed(seed))
        return torch.cat([p.flatten() for p in m.parameters()])
    a, b = draw(0), draw(1)
    assert torch.equal(a, draw(0)) and not torch.equal(a, b)
