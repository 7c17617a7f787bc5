"""The port's config-driven schedules and optimizers
(``training/schedules.py``) against the JAX package's optax ones
(ditsep_tpu/training/schedules.py) on the CPU, with parameters and
gradients made by numpy from a seed.

Bars, stated before the runs: every scheduler type's rate at update
counts 0-299 (past ``T_max`` and ``total_iters``) within 2^-22 of the base
rate of optax's jitted schedule, 2 float32 ulps of the base rate: XLA
rewrites the schedule as it compiles it (a division by a constant
becomes a multiplication by its reciprocal, constants fold, ``x ** 1.0``
becomes x) and its float32 ``pow`` and ``cos`` are approximations of
their own, so no evaluation in the port reproduces every count bit for
bit (the port's lie within 1.5e-7 of the base rate); the cosine held at
``eta_min`` after ``T_max``. Parameters after 5 updates of each optimizer
type under a schedule (AdamW, FusedAdam, Adam with its coupled decay,
SGD plain and with nesterov momentum, RMSprop with and without momentum)
within 1e-6 of max|ref| a leaf, with and without a global-norm clip first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ditsep_tpu.training import schedules as js
from ditsep_tpu_torch.training import schedules as ts

SCHEDULES = {
    "inverse": {"type": "InverseLR", "config": {
        "inv_gamma": 1000, "power": 0.5, "warmup": 0.99}},
    "inverse_defaults": {"type": "InverseLR"},
    "exponential": {"type": "ExponentialLR", "config": {"gamma": 0.99}},
    "exponential_half": {"type": "ExponentialLR", "config": {"gamma": 0.5}},
    "cosine": {"type": "CosineAnnealingLR", "config": {
        "T_max": 100, "eta_min": 1e-5}},
    "cosine_short": {"type": "CosineAnnealingLR", "config": {"T_max": 7}},
    "linear_up": {"type": "LinearLR", "config": {
        "start_factor": 0.1, "end_factor": 1.0, "total_iters": 50}},
    "linear_down": {"type": "LinearLR", "config": {
        "start_factor": 1.0, "end_factor": 0.1, "total_iters": 37}},
    "linear_defaults": {"type": "LinearLR"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    cfg = SCHEDULES[name]
    counts = np.arange(300)
    for lr in (1e-4, 1.5e-4, 3e-3):
        jfn = jax.jit(jax.vmap(js.create_schedule_from_config(cfg, lr)))
        want = np.asarray(jfn(jnp.asarray(counts, jnp.int32)))
        fn = ts.create_schedule_from_config(cfg, lr)
        got = np.array([fn(int(n)) for n in counts], np.float32)
        assert np.abs(got - want).max() <= 2.0 ** -22 * lr, (name, lr)
    if cfg["type"] == "CosineAnnealingLR":
        t_max = cfg["config"]["T_max"]
        held = {fn(n) for n in range(t_max, 300)}
        assert held == {fn(t_max)}
        assert abs(fn(t_max) - cfg["config"].get("eta_min", 0.0)) <= 1e-9


def test_unknown_types_raise():
    with pytest.raises(NotImplementedError):
        ts.create_schedule_from_config({"type": "StepLR"}, 1e-3)
    with pytest.raises(NotImplementedError):
        ts.create_optimizer_from_config({"type": "Adagrad"})
    with pytest.raises(ValueError):
        ts.create_schedule_from_config({"type": "CosineAnnealingLR",
                                        "config": {"T_max": 0}}, 1e-3)


OPTIMIZERS = {
    "adamw": ({"type": "AdamW", "config": {
        "lr": 1e-2, "betas": [0.8, 0.99], "weight_decay": 1e-3,
        "amsgrad": True, "eps": 1e-6}}, SCHEDULES["inverse"]),
    "fused_adam": ({"type": "FusedAdam", "config": {
        "lr": 1e-2, "weight_decay": 0.1}}, SCHEDULES["cosine_short"]),
    "adam_coupled_decay": ({"type": "Adam", "config": {
        "lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        SCHEDULES["exponential"]),
    "sgd": ({"type": "SGD", "config": {"lr": 1e-2}}, None),
    "sgd_nesterov": ({"type": "SGD", "config": {
        "lr": 1e-2, "momentum": 0.9, "nesterov": True}},
        SCHEDULES["linear_up"]),
    "rmsprop": ({"type": "RMSprop", "config": {"lr": 1e-2, "alpha": 0.9}},
                SCHEDULES["linear_down"]),
    "rmsprop_momentum": ({"type": "RMSprop", "config": {
        "lr": 1e-2, "momentum": 0.9}}, SCHEDULES["cosine"]),
}


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name, clip):
    opt_cfg, sched = OPTIMIZERS[name]
    rng = np.random.default_rng(len(name))
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in (("a", (3, 4)), ("b", (5,)))}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = js.create_optimizer_from_config(opt_cfg, sched)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(pj)

    @jax.jit
    def update(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    params = [torch.from_numpy(p0[k].copy()) for k in ("a", "b")]
    opt = ts.create_optimizer_from_config(opt_cfg, sched).build(params,
                                                                clip=clip)
    for g in grads:
        pj, st = update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
    assert opt.count == 5
    for k, p in zip(("a", "b"), params):
        want = np.asarray(pj[k])
        assert not np.array_equal(want, p0[k])
        assert np.abs(p.numpy() - want).max() <= 1e-6 * np.abs(want).max(), k
    again = ts.create_optimizer_from_config(opt_cfg, sched).build(
        [p.clone() for p in params], clip=clip)
    again.load_state_dict(opt.state_dict())
    assert again.count == 5


def test_rmsprop_is_optax_not_torch():
    """optax divides by sqrt(nu + eps), torch's RMSprop by sqrt(nu) + eps:
    on a tiny gradient the two part, and the port follows optax."""
    g = np.full((4,), 1e-5, np.float32)
    tx = optax.rmsprop(1e-2, decay=0.99)
    pj = jnp.zeros(4)
    upd, _ = tx.update(jnp.asarray(g), tx.init(pj), pj)
    p = torch.zeros(4)
    opt = ts.create_optimizer_from_config(
        {"type": "RMSprop", "config": {"lr": 1e-2}}).build([p])
    opt.step([torch.from_numpy(g)])
    np.testing.assert_allclose(p.numpy(), np.asarray(upd), rtol=1e-6)
    q = torch.zeros(4, requires_grad=True)
    ref = torch.optim.RMSprop([q], lr=1e-2, alpha=0.99, eps=1e-8)
    q.grad = torch.from_numpy(g)
    ref.step()
    assert np.abs(q.detach().numpy() - np.asarray(upd)).max() > 1e-3
