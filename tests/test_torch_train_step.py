"""The port's ``DiffSepTrainer.train_step`` against the JAX package's, on the
CPU, with JAX's own random draws (tests/test_torch_train.py:jax_draws).

Three steps of the optimizer alone on the toy score model (the default
Adam with clipping, a linear warmup, ``accumulate_grad_batches=2`` as
optax.MultiSteps, and a clip that always triggers), then two steps of the
tiny NCSN++ through JAX's jitted ``train_step``.

Tolerances, stated before the runs: the loss 1e-4 relative, the grad norm
1e-4 relative; after step n the parameters within n * 1e-3 * lr wherever
the gradient was at least 1e-3 of its leaf's largest in every step so far
(a leaf of round-off gradient, under 1e-6 of the largest, has none), and
within n * 2 * lr everywhere (Adam's first step is lr * g / (|g| +
eps): a near-zero gradient of another sign moves by up to 2 lr); the EMA
within the same bars times (1 - decay), plus 2 float32 ulps of its value
(its own rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu_torch.utils.separate import normalize_batch
from test_torch_train import (
    _batch, flat_torch_layout, jax_draws, tiny_ncsnpp_pair, toy_pair,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaf_bars(grads_hist, lr, n):
    """Per leaf: the bar of each element after n steps. A leaf whose
    gradient is round-off (its largest under 1e-6 of the largest of all
    leaves: the attention's key bias, whose exact gradient is 0) has no
    significant element."""
    bars = {}
    for k in grads_hist[0]:
        sig = np.ones(grads_hist[0][k].shape, bool)
        for g in grads_hist:
            a = np.abs(g[k])
            top = max(np.abs(v).max() for v in g.values())
            sig &= (a >= 1e-3 * a.max()) & (a.max() >= 1e-6 * top)
        bars[k] = np.where(sig, n * 1e-3 * lr, n * 2 * lr)
    return bars


def _check_state(tt, model_sd, ema_sd, jax_params, jax_ema, bars, decay):
    want_p = flat_torch_layout(jax_params)
    want_e = flat_torch_layout(jax_ema)
    assert set(want_p) == set(model_sd)
    for k, v in model_sd.items():
        bar = bars.get(k, 1e-9)  # buffers (the Fourier W) do not move
        err = np.abs(v.numpy() - want_p[k])
        assert (err <= bar).all(), (k, float(err.max()))
        e = ema_sd[k].numpy()
        slack = 2 * np.spacing(np.abs(want_e[k]).astype(np.float32))
        err = np.abs(e - want_e[k])
        assert (err <= bar * (1 - decay) + slack).all(), (k, float(err.max()))


def _run(jt, params, tt, batches, keys, jit):
    """Both train steps over the batches; checks after each step."""
    step = jax.jit(jt.train_step) if jit else jt.train_step
    st = jt.init_state(params)
    state = tt.init_state()
    cfg = tt.cfg
    named = dict(tt.model.named_parameters())
    grads_hist = []
    for n, ((mix, tgt), key) in enumerate(zip(batches, keys), start=1):
        st, mj = step(st, key, (jnp.asarray(mix), jnp.asarray(tgt)))
        draws = jax_draws(cfg, key, *tgt.shape)
        # this step's gradient, for the significance mask
        (m_n, t_n), _, _ = normalize_batch((torch.from_numpy(mix),
                                            torch.from_numpy(tgt)))
        loss = tt.training_loss(tt.model, m_n, t_n, draws=draws)
        grads_hist.append({k: g.numpy() for k, g in zip(
            named, torch.autograd.grad(loss, list(named.values())))})
        state, mt = tt.train_step(state, (torch.from_numpy(mix),
                                          torch.from_numpy(tgt)), draws=draws)
        assert state.step == n == int(st.step)
        lj, gj = float(mj["train/score_loss"]), float(mj["train/grad_norm"])
        assert abs(mt["train/score_loss"].item() - lj) <= 1e-4 * abs(lj)
        assert abs(mt["train/grad_norm"].item() - gj) <= 1e-4 * gj
        bars = _leaf_bars(grads_hist, cfg.lr, n)
        _check_state(tt, state.model.state_dict(), state.ema.state_dict(),
                     st.params, st.ema_params, bars, cfg.ema_decay)
    return st, state


TOY_CONFIGS = {
    "default": {},
    "warmup": {"lr_warmup": 2},
    "accumulate": {"accumulate_grad_batches": 2},
    "clip_always": {"grad_clip": 1e-3},
}


@pytest.mark.parametrize("name", sorted(TOY_CONFIGS))
def test_train_steps_match_jax_toy(name):
    jt, params, tt = toy_pair(**TOY_CONFIGS[name])
    batches = [_batch(seed=20 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    st, state = _run(jt, params, tt, batches, keys, jit=False)
    cfg = tt.cfg
    opt = state.optimizer
    updates = 3 // cfg.accumulate_grad_batches
    assert opt.count == updates
    if name == "warmup":  # the first update moves nothing (rate 0)
        factor = opt.schedule.lr_lambdas[0]
        assert (factor(0), factor(1), factor(2)) == (0.0, 0.5, 1.0)
    assert opt.adam.param_groups[0]["lr"] == cfg.lr
    if name == "accumulate":
        assert opt.mini_step == 1  # the third micro-step is pending


def test_train_steps_match_jax_ncsnpp():
    length = 800
    jt, params, tt = tiny_ncsnpp_pair(length)
    rng = np.random.default_rng(9)
    batches = []
    for i in range(2):
        mix, tgt = _batch(b=2, t_len=length, seed=40 + i)
        batches.append((mix + 0.01 * rng.standard_normal(mix.shape).astype(
            np.float32), tgt))
    keys = [jax.random.PRNGKey(50 + i) for i in range(2)]
    _run(jt, params, tt, batches, keys, jit=True)


def test_train_step_draws_from_generator_and_refuses_dropout():
    _, _, tt = toy_pair()
    mix, tgt = _batch()
    runs = []
    for _ in range(2):
        _, _, tt = toy_pair()
        state = tt.init_state()
        state, m = tt.train_step(state, (torch.from_numpy(mix),
                                         torch.from_numpy(tgt)),
                                 generator=torch.Generator().manual_seed(3))
        runs.append((m["train/score_loss"], state.model.W.detach().clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    tt.model.drop = torch.nn.Dropout(0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        tt.train_step(tt.init_state(), (torch.from_numpy(mix),
                                        torch.from_numpy(tgt)))
