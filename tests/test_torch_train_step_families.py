"""Two ``train_step``s of each new family's config (diffsep_ouve,
diffsep_sb with its EDM loss, enhancement with PriorMix and init hack 4)
in the port against the JAX package's jitted ones, on the CPU, through a
tiny NCSN++ with the same weights and JAX's own random draws
(tests/test_torch_train.py:jax_draws).

Tolerances, stated before the runs: tests/test_torch_train_step.py's (the
loss and grad norm 1e-4 relative; after step n the parameters within
n * 1e-3 * lr where the gradient is significant, n * 2 * lr elsewhere, the
EMA the same times (1 - decay) plus 2 ulps). Where Adam's first moment
nearly cancels, that parameter bar lies below float32 reproducibility;
``_run_steps`` says how the bar accounts for it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.utils import separate as jax_sep
from ditsep_tpu_torch.utils.separate import normalize_batch
from test_torch_train import _batch, flat_torch_layout, jax_draws
from test_torch_train_families import FAMILIES, tiny_family_pair
from test_torch_train_step import _check_state, _leaf_bars


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _adam(p0, grads, lr, clip):
    """optax's clip_by_global_norm + adam in float64 over a gradient
    history: the parameters after each step."""
    p = {k: v.astype(np.float64) for k, v in p0.items()}
    m = {k: 0.0 for k in p}
    v = {k: 0.0 for k in p}
    out = []
    for n, g in enumerate(grads, start=1):
        norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                           for a in g.values()))
        scale = 1.0 if norm < clip else clip / norm
        for k in p:
            gk = g[k].astype(np.float64) * scale
            m[k] = 0.9 * m[k] + 0.1 * gk
            v[k] = 0.999 * v[k] + 0.001 * gk ** 2
            p[k] = p[k] - lr * (m[k] / (1 - 0.9 ** n)) / (
                np.sqrt(v[k] / (1 - 0.999 ** n)) + 1e-8)
        out.append({k: a.copy() for k, a in p.items()})
    return out


def _run_steps(jt, params, tt, batches, keys):
    """Both packages' train steps over the batches, checked after each:
    the loss and grad norm at tests/test_torch_train_step.py's bars, and
    the parameters and EMA at that file's bars plus twice the part of
    the difference that the gradients' own difference explains, found by
    running clip + Adam in float64 on each side's gradient history. Adam
    divides by the root of its second moment, so where its first moment
    nearly cancels it magnifies a round-off difference of the gradient:
    JAX's own jitted and eager steps part by up to 2.7 times the plain
    bar on these families (and 1.05 times on diffsep)."""
    step = jax.jit(jt.train_step)
    grad_j = jax.jit(lambda p, k, m, t: jax.grad(
        lambda q: jt.training_loss(q, k, m, t, train=True))(p))
    st, state = jt.init_state(params), tt.init_state()
    named = dict(tt.model.named_parameters())
    p0 = {k: v.detach().numpy().copy() for k, v in named.items()}
    lr, decay = tt.cfg.lr, tt.cfg.ema_decay
    hist_j, hist_t = [], []
    for n, ((mix, tgt), key) in enumerate(zip(batches, keys), start=1):
        (jm, jtg), _, _ = jax_sep.normalize_batch((jnp.asarray(mix),
                                                   jnp.asarray(tgt)))
        want = flat_torch_layout(grad_j(st.params, key, jm, jtg))
        want.pop("backbone.all_modules.0.W")  # a buffer in the port
        draws = jax_draws(tt.cfg, key, *tgt.shape)
        (m_n, t_n), _, _ = normalize_batch((torch.from_numpy(mix),
                                            torch.from_numpy(tgt)))
        loss = tt.training_loss(tt.model, m_n, t_n, draws=draws)
        got = dict(zip(named, (g.numpy() for g in torch.autograd.grad(
            loss, list(named.values())))))
        hist_j.append(want)
        hist_t.append(got)
        st, mj = step(st, key, (jnp.asarray(mix), jnp.asarray(tgt)))
        state, mt = tt.train_step(state, (torch.from_numpy(mix),
                                          torch.from_numpy(tgt)), draws=draws)
        assert state.step == n == int(st.step)
        lj, gj = float(mj["train/score_loss"]), float(mj["train/grad_norm"])
        assert abs(mt["train/score_loss"].item() - lj) <= 1e-4 * abs(lj)
        assert abs(mt["train/grad_norm"].item() - gj) <= 1e-4 * gj
        explained = {k: 2 * np.abs(a - b) for k, a, b in zip(
            p0, _adam(p0, hist_j, lr, tt.cfg.grad_clip)[-1].values(),
            _adam(p0, hist_t, lr, tt.cfg.grad_clip)[-1].values())}
        bars = {k: b + explained[k]
                for k, b in _leaf_bars(hist_t, lr, n).items()}
        _check_state(tt, state.model.state_dict(), state.ema.state_dict(),
                     st.params, st.ema_params, bars, decay)


@pytest.mark.parametrize("family", sorted(FAMILIES.values()))
def test_train_steps_match_jax(family):
    length = 800
    jt, params, tt = tiny_family_pair(family, length)
    rng = np.random.default_rng(9)
    batches = []
    for i in range(2):
        mix, tgt = _batch(b=2, t_len=length, seed=60 + i)
        batches.append((mix + 0.01 * rng.standard_normal(mix.shape).astype(
            np.float32), tgt))
    keys = [jax.random.PRNGKey(70 + i) for i in range(2)]
    _run_steps(jt, params, tt, batches, keys)
