"""Latent training in the port against the JAX package on the CPU: the
loss, its gradients and two ``train_step_latent`` steps, with JAX's draws
rebuilt from its key splits (the VAE's posterior samples and the loss's),
on tests/test_torch_latent.py's tiny pair; and the frozen VAE.

Tolerances, stated before the runs: the latent training loss 1e-4
relative; its gradients 1e-3 of each leaf's max|ref| (the attention's key
bias, whose exact gradient is 0, within 1e-6 of the largest leaf's max);
the train steps at PR 5's bars (tests/test_torch_train_step.py): loss and
grad norm 1e-4 relative, after step n the parameters n * 1e-3 * lr where
the gradient is significant and n * 2 * lr elsewhere, the EMA the same
times (1 - decay) plus 2 ulps, each parameter bar plus twice the part the
two sides' gradients explain through float64 clip + Adam, as the family
steps' (tests/test_torch_train_step_families.py); the VAE bit for bit
unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_latent import _batch, latent_loss_draws, tiny_latent_pair
from test_torch_train import _close, flat_torch_layout
from test_torch_train_step import _check_state, _leaf_bars
from test_torch_train_step_families import _adam


def _fresh_pair():
    """A pair of its own: the train steps update the port's weights."""
    return tiny_latent_pair.__wrapped__()


def test_training_loss_and_gradients_match_jax():
    """The latent loss with JAX's draws, init hack 5 (one item on each
    branch of its mixture, by the draws), then the score model's
    gradients leaf by leaf."""
    jt, params, vae_params, tt = tiny_latent_pair()
    mix, tgt = _batch(seed=7)
    key = jax.random.PRNGKey(11)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jt.training_loss_latent(p, vae_params, key,
                                          jnp.asarray(mix),
                                          jnp.asarray(tgt))))(params)
    draws = latent_loss_draws(tt.cfg, key)
    named = dict(tt.model.named_parameters())
    loss_t = tt.training_loss_latent(tt.model, torch.from_numpy(mix),
                                     torch.from_numpy(tgt), draws=draws)
    grads_t = dict(zip(named, torch.autograd.grad(loss_t,
                                                  list(named.values()))))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = flat_torch_layout(grads_j)
    assert set(want) - set(grads_t) == {"backbone.all_modules.0.W"}
    assert not want["backbone.all_modules.0.W"].any()  # stop_gradient
    top = max(np.abs(v).max() for v in want.values())
    for k, g in grads_t.items():
        if k.endswith("NIN_1.b"):  # the attention's key bias: exactly 0
            assert max(np.abs(want[k]).max(), g.abs().max()) <= 1e-6 * top
        else:
            _close(g, want[k], 1e-3)


def test_train_steps_latent_match_jax_and_keep_the_vae_frozen():
    """Two steps at PR 5's bars plus, as the family steps
    (tests/test_torch_train_step_families.py:_run_steps), twice the part
    of the difference that the two sides' gradients explain through
    float64 clip + Adam: where Adam's first moment nearly cancels, the
    plain bar lies below float32 reproducibility (ROADMAP C)."""
    jt, params, vae_params, tt = _fresh_pair()
    vae_before = {k: v.clone() for k, v in tt.vae.state_dict().items()}
    step = jax.jit(jt.train_step_latent)
    grad_j = jax.jit(lambda p, k, m, t: jax.grad(
        lambda q: jt.training_loss_latent(q, vae_params, k, m, t))(p))
    st = jt.init_state(params)
    state = tt.init_state()
    cfg = tt.cfg
    named = dict(tt.model.named_parameters())
    p0 = {k: v.detach().numpy().copy() for k, v in named.items()}
    hist_j, hist_t = [], []
    for n in (1, 2):
        mix, tgt = _batch(seed=40 + n)
        key = jax.random.PRNGKey(50 + n)
        want = flat_torch_layout(grad_j(st.params, key, jnp.asarray(mix),
                                        jnp.asarray(tgt)))
        want.pop("backbone.all_modules.0.W")  # a buffer in the port
        hist_j.append(want)
        st, mj = step(st, vae_params, key, (jnp.asarray(mix),
                                             jnp.asarray(tgt)))
        draws = latent_loss_draws(cfg, key)
        loss = tt.training_loss_latent(tt.model, torch.from_numpy(mix),
                                       torch.from_numpy(tgt), draws=draws)
        hist_t.append({k: g.numpy() for k, g in zip(
            named, torch.autograd.grad(loss, list(named.values())))})
        state, mt = tt.train_step_latent(
            state, (torch.from_numpy(mix), torch.from_numpy(tgt)),
            draws=draws)
        assert state.step == n == int(st.step)
        lj, gj = float(mj["train/score_loss"]), float(mj["train/grad_norm"])
        assert abs(mt["train/score_loss"].item() - lj) <= 1e-4 * abs(lj)
        assert abs(mt["train/grad_norm"].item() - gj) <= 1e-4 * gj
        explained = {k: 2 * np.abs(a - b) for k, a, b in zip(
            p0, _adam(p0, hist_j, cfg.lr, cfg.grad_clip)[-1].values(),
            _adam(p0, hist_t, cfg.lr, cfg.grad_clip)[-1].values())}
        bars = {k: b + explained[k]
                for k, b in _leaf_bars(hist_t, cfg.lr, n).items()}
        _check_state(tt, state.model.state_dict(), state.ema.state_dict(),
                     st.params, st.ema_params, bars, cfg.ema_decay)
    # the VAE: no gradient, untouched, in neither the optimizer, the EMA
    # nor the checkpoint
    assert not any(p.requires_grad for p in tt.vae.parameters())
    for k, v in tt.vae.state_dict().items():
        assert torch.equal(v, vae_before[k]), k
    vae_ids = {id(p) for p in tt.vae.parameters()}
    assert not vae_ids & {id(p) for p in state.optimizer.params}
    assert {id(p) for p in state.optimizer.params} == {
        id(p) for p in tt.model.parameters()}
    assert set(state.ema.state_dict()) == set(tt.model.state_dict())
    saved = state.state_dict()
    assert set(saved["model"]) == set(tt.model.state_dict())


def test_train_step_latent_draws_from_the_generator():
    """Without draws every draw (the posterior samples too) comes from the
    generator: one seed, one step."""
    mix, tgt = _batch(seed=60)
    losses = []
    for _ in range(2):
        _, _, _, tt = _fresh_pair()
        state = tt.init_state()
        _, m = tt.train_step_latent(
            state, (torch.from_numpy(mix), torch.from_numpy(tgt)),
            generator=torch.Generator().manual_seed(5))
        losses.append(m["train/score_loss"])
    assert torch.equal(losses[0], losses[1])
    assert torch.isfinite(losses[0])


def main():
    """Print the two latent train steps' worst parameter error against
    JAX's, over PR 5's plain bar and over the bar with the explained part
    (PERF.md's parity table):

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_latent_train.py
    """
    import json
    jt, params, vae_params, tt = _fresh_pair()
    step = jax.jit(jt.train_step_latent)
    grad_j = jax.jit(lambda p, k, m, t: jax.grad(
        lambda q: jt.training_loss_latent(q, vae_params, k, m, t))(p))
    st, state, cfg = jt.init_state(params), tt.init_state(), tt.cfg
    named = dict(tt.model.named_parameters())
    p0 = {k: v.detach().numpy().copy() for k, v in named.items()}
    hist_j, hist_t = [], []
    for n in (1, 2):
        mix, tgt = _batch(seed=40 + n)
        key = jax.random.PRNGKey(50 + n)
        want = flat_torch_layout(grad_j(st.params, key, jnp.asarray(mix),
                                        jnp.asarray(tgt)))
        want.pop("backbone.all_modules.0.W")
        hist_j.append(want)
        st, _ = step(st, vae_params, key, (jnp.asarray(mix),
                                            jnp.asarray(tgt)))
        draws = latent_loss_draws(cfg, key)
        loss = tt.training_loss_latent(tt.model, torch.from_numpy(mix),
                                       torch.from_numpy(tgt), draws=draws)
        hist_t.append({k: g.numpy() for k, g in zip(
            named, torch.autograd.grad(loss, list(named.values())))})
        state, _ = tt.train_step_latent(
            state, (torch.from_numpy(mix), torch.from_numpy(tgt)),
            draws=draws)
        explained = {k: 2 * np.abs(a - b) for k, a, b in zip(
            p0, _adam(p0, hist_j, cfg.lr, cfg.grad_clip)[-1].values(),
            _adam(p0, hist_t, cfg.lr, cfg.grad_clip)[-1].values())}
        want_p = flat_torch_layout(st.params)
        plain = _leaf_bars(hist_t, cfg.lr, n)
        got = state.model.state_dict()
        err = {k: np.abs(got[k].numpy() - want_p[k]) for k in plain}
        print(json.dumps({
            "step": n,
            "param_over_plain_bar": float(max(
                (err[k] / plain[k]).max() for k in plain)),
            "param_over_explained_bar": float(max(
                (err[k] / (plain[k] + explained[k])).max()
                for k in plain))}))


if __name__ == "__main__":
    main()
