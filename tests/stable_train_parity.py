"""Shared helpers of the training parity tests (tests/test_torch_{ldm,
diffusion_train,diffae_lm_train,vaegan_families}.py and those that import
test_torch_ldm's): JAX's
gradient trees carried to the port's keys, the train-step bars of
tests/test_torch_train_step.py (each step's gradient leaf by leaf within
1e-3 of the reference leaf's max|ref|; after n steps the parameters
within the sum of the applied rates times 1e-3 where the gradient was
significant in every step, 2 elsewhere, plus twice the part that float64
clip + AdamW explains of the two gradient histories; the EMA the same
times (1 - decay) plus 2 ulps)."""
import jax
import numpy as np

from ditsep_tpu_torch.models.weights import params_from_jax
from stable_audio_parity import flat


def torch_tree(jax_tree, model) -> dict:
    """A JAX parameter (or gradient) tree of ``model``'s flax twin -> the
    port's keys, numpy arrays in the port's layouts."""
    return {k: v.numpy() for k, v in params_from_jax(
        flat(jax_tree), model).items()}


def snapshot(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def adamw_f64(p0, grads, rates, clip=np.inf, b1=0.9, b2=0.999, wd=1e-3):
    """optax's clip_by_global_norm + adamw in float64 over a gradient
    history, step n at rates[n]: the parameters after the last step."""
    p = {k: v.astype(np.float64) for k, v in p0.items() if k in grads[0]}
    m = {k: 0.0 for k in p}
    v = {k: 0.0 for k in p}
    for n, (g, lr) in enumerate(zip(grads, rates), start=1):
        norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                           for a in g.values()))
        scale = 1.0 if norm < clip else clip / norm
        for k in p:
            gk = g[k].astype(np.float64) * scale
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk ** 2
            upd = (m[k] / (1 - b1 ** n)) / (
                np.sqrt(v[k] / (1 - b2 ** n)) + 1e-8)
            p[k] = p[k] - lr * (upd + wd * p[k])
    return p


def step_bars(hist_t, hist_j, p0, rates, **adam) -> dict:
    """Per leaf, the parameter bar after len(hist_t) steps (module
    docstring); ``adam`` the optimizer's clip, b1, b2, wd."""
    a = adamw_f64(p0, hist_j, rates, **adam)
    b = adamw_f64(p0, hist_t, rates, **adam)
    bars = {}
    for k in a:
        sig = np.ones(p0[k].shape, bool)
        for g in hist_t:
            top = max(np.abs(x).max() for x in g.values())
            x = np.abs(g[k])
            sig &= (x >= 1e-3 * x.max()) & (x.max() >= 1e-6 * top)
        bars[k] = (np.where(sig, 1e-3 * sum(rates), 2 * sum(rates))
                   + 2 * np.abs(a[k] - b[k]))
    return bars


def check_grads(got, want, what, floor_share=0.0):
    """A step's gradient leaf by leaf within 1e-3 of the reference leaf's
    max|ref| (a leaf of zeros exactly 0; with ``floor_share``, at least
    that share of the largest leaf's max: a hinge's near-cancelled
    leaves), before any parameter bar: the explained part of the bars
    comes from the two gradient histories, so only this check holds a
    wrong gradient to account."""
    assert set(got) == set(want), what
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= max(1e-3 * np.abs(w).max(), floor_share * top), (
            what, k, float(err))


def check_params(got, want, bars, what):
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert (err <= bars[k]).all(), (what, k, float(err.max()),
                                        float(bars[k].max()))


def check_steps(hist_t, hist_j, p0, rates, got, want, ema_got, ema_want,
                decay, what, **adam):
    """After the steps of the histories: each step's gradient
    (``check_grads``), the parameters at ``step_bars``, the EMA at those
    bars times (1 - decay) plus 2 ulps."""
    for n, (gt, gj) in enumerate(zip(hist_t, hist_j)):
        check_grads(gt, gj, f"{what} step {n}")
    bars = step_bars(hist_t, hist_j, p0, rates, **adam)
    check_params(got, want, bars, what)
    check_params(ema_got, ema_want, {
        k: b * (1 - decay) + 2 * np.spacing(np.abs(ema_want[k]))
        for k, b in bars.items()}, f"{what} EMA")


def jit_step_and_grad(trainer):
    """One jitted function (one compile) of JAX's ``trainer``: (the
    gradient of ``trainer.loss`` at the state's parameters, the state after
    ``trainer.train_step``, its metrics), the step's arguments after the
    state."""
    def both(state, *args):
        return (jax.grad(trainer.loss)(state.params, *args),
                *trainer.train_step(state, *args))
    return jax.jit(both)
