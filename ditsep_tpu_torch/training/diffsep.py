"""DiffSep training and separation around a score model (port of
ditsep_tpu/training/diffsep.py): the score-matching losses with their PIT
variants and init hacks 4-7, the optimizer (Adam after global-norm
clipping, optional linear warmup and gradient accumulation, as the JAX
package's optax chain), the train step with its EMA, validation, and
separation. Behaviour follows the SDE's type, as in the JAX package: the
matrix SDEs (MixSDE, PriorMixSDE) anchor the init hacks at mix / n and
sample with PC + ald2; the scalar ones (OUVESDE, SBVESDE) anchor at the
full mixture and sample with PC + ald, or, for SBVESDE, with the
Schroedinger-bridge sampler and the score network under EDM
preconditioning.

Randomness is explicit. Every loss and ``train_step`` draws from a
``torch.Generator`` on the batch's device, or takes ``draws``: the raw
standard-uniform / standard-normal (and integer) arrays the JAX code draws,
by role, to which the port applies the JAX code's transforms (threshold,
argsort, scaling to [t_eps, T]):

* ``time_u`` (B,) uniforms of the sampled time (``varprop``: (8B,)
  proposals, with ``time_accept_u``);
* ``z`` (B, n, T) normals of the perturbation;
* ``select_u`` (B,) uniforms of init hack 4's t=T clamp;
* ``pit_z`` (B, n, T) normals of the t=T PIT loss (init hacks 5-7);
* ``mask_u`` (B,) uniforms choosing that loss per item (init hacks 5-7);
* ``shuffle_u`` (B, n) uniforms whose argsort shuffles the sources;
* ``sel`` (B,) integers choosing the permutation of the mmnr-gated PIT.

As in the JAX package, each PIT variant runs the network once: its input
does not depend on the permutation, which enters only the loss target.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.sdes import (
    BaseSDE, MixSDE, SBVESDE, ab2_sample, bcast_right, pc_sample, sb_sample,
)
from ditsep_tpu_torch.sdes.core import VARPROP_OVERSAMPLE
from ditsep_tpu_torch.training import losses as loss_lib
from ditsep_tpu_torch.utils import separate as sep_utils

Tensor = torch.Tensor
Draws = Optional[Mapping[str, object]]


@dataclasses.dataclass(frozen=True)
class DiffSepConfig:
    """Hyperparameters mirroring the reference model config."""

    n_speakers: int = 2
    t_eps: float = 0.03
    t_rev_init: float = 0.03
    ema_decay: float = 0.999
    time_sampling_strategy: str = "uniform"
    train_source_order: str = "power"
    init_hack: int = 5
    init_hack_p: float = 0.1
    mmnr_thresh_pit: float = -10.0
    lr: float = 2e-4
    lr_warmup: Optional[int] = None
    grad_clip: float = 5.0
    accumulate_grad_batches: int = 1
    sampler_N: int = 30
    sampler_snr: float = 0.5
    sampler_corrector_steps: int = 1
    network_scaling: str = "1/sigma"
    c: str = "edm"
    sigma_data: float = 0.1


def _batch_mean(x: Tensor) -> Tensor:
    """Mean over all non-batch axes -> (B,)."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def _perms(n: int) -> List[Tuple[int, ...]]:
    return list(itertools.permutations(range(n)))


def _draw(draws: Draws, name: str, shape: Sequence[int], kind: str,
          generator: Optional[torch.Generator], device, low: int = 0,
          high: Optional[int] = None) -> Tensor:
    """The raw draw ``name`` of batch-leading ``shape``: from ``draws`` when
    given (every name a loss needs must be there; kept on its device when
    ``device`` is None), else a ``kind`` ("uniform", "normal", or "int" in
    [low, high)) draw from ``generator`` on ``device``. In a shard of a
    global batch (``parallel.sharded``) both are the global batch's draws,
    of which the shard keeps its rows."""
    if draws is not None:
        if name not in draws:
            raise KeyError(f"draws has no {name!r} (has {sorted(draws)})")
        a = draws[name]
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))
        want = (parallel.global_rows(shape[0]),) + tuple(shape[1:])
        if tuple(a.shape) != want:
            raise ValueError(f"draws[{name!r}] has shape {tuple(a.shape)}, "
                             f"want {want}")
        a = parallel.take_rows(a)
        return a if device is None else a.to(device)
    if kind == "uniform":
        fn = torch.rand
    elif kind == "normal":
        fn = torch.randn
    elif kind == "int" and high is not None:
        def fn(s, **kw):
            return torch.randint(low, high, s, **kw)
    else:
        raise ValueError(f"no generator draw of kind {kind!r} for {name!r}")
    return parallel.draw_rows(
        lambda s: fn(s, generator=generator, device=device), shape)


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool):
    """``model`` in train or eval mode inside the block, then as before."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


class ClipAdam:
    """What the JAX package's ``make_optimizer`` builds with optax:
    ``chain(clip_by_global_norm(clip), adam(lr or linear_schedule(0, lr,
    warmup)))``, inside ``MultiSteps(k)`` when k > 1, on a list of float32
    parameters, updated in place.

    The update is ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, bias correction by the count of applied updates, as
    optax's) under a ``LambdaLR`` warmup of lr * min(n, warmup) / warmup
    at the n-th update counted from 0, so the first update moves nothing.
    What optax does otherwise is done here: the global norm scales by
    clip/norm only when norm >= clip (no epsilon), and with k > 1 the
    gradients of k micro-steps are averaged (Welford: acc + (g - acc) /
    (n + 1)), clipped and applied on the k-th, the micro-steps between
    applying nothing."""

    def __init__(self, params: Sequence[Tensor], lr: float, grad_clip: float,
                 warmup: Optional[int] = None, accumulate: int = 1):
        self.params = list(params)
        self.grad_clip, self.accumulate = grad_clip, accumulate
        self.mini_step = 0   # micro-steps accumulated since the last update
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, foreach=True)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adam, (lambda n: min(n, warmup) / warmup) if warmup
            else (lambda n: 1.0))
        with torch.no_grad():
            self.acc = ([torch.zeros_like(p) for p in self.params]
                        if accumulate > 1 else None)

    @property
    def count(self) -> int:
        """Updates applied (optax's adam / schedule count)."""
        return self.schedule.last_epoch

    @torch.no_grad()
    def step(self, grads: Sequence[Tensor]) -> bool:
        """Take one micro-step's gradients; returns whether the parameters
        were updated."""
        grads = list(grads)
        if self.acc is not None:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            if self.mini_step < self.accumulate - 1:
                self.mini_step += 1
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        clip_by_global_norm_(grads, self.grad_clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.schedule.step()
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(),
                "schedule": self.schedule.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.schedule.load_state_dict(state["schedule"])
        self.mini_step = state["mini_step"]
        for a, b in zip(self.acc or (), state["acc"] or ()):
            a.copy_(b)


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt(sum of squares) over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def clip_by_global_norm_(grads: List[Tensor], clip: float) -> None:
    """optax's clip_by_global_norm in place: scale by clip / norm when the
    global norm is at least ``clip`` (no epsilon)."""
    norm = global_norm(grads)
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, scale)


@torch.no_grad()
def ema_update_(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * model, over the floating-point
    parameters and buffers, as the JAX package's tree map."""
    e = [t for t in ema.state_dict().values() if t.is_floating_point()]
    cur = [t for t in model.state_dict().values() if t.is_floating_point()]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(cur, 1.0 - decay))


@dataclasses.dataclass
class TrainState:
    """The counterpart of the JAX TrainState: ``step`` (micro-steps taken),
    ``model`` (the trained module, its parameters updated in place),
    ``optimizer`` and ``ema`` (a copy of the model holding the EMA of its
    parameters and buffers). ``media_failures`` counts the demo callbacks
    and validation media that failed in the ``fit`` run that returned the
    state (not saved)."""

    step: int
    model: nn.Module
    optimizer: ClipAdam
    ema: nn.Module
    media_failures: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.ema.load_state_dict(state["ema"])


@dataclasses.dataclass(frozen=True)
class DiffSepTrainer:
    """``model`` is an nn.Module (xt, time, mix) -> score holding its own
    parameters; ``sde`` one of the SDE dataclasses. The methods take the
    module to run (``model``; None: the trainer's), as the JAX ones take
    ``params``."""

    model: nn.Module
    sde: BaseSDE
    cfg: DiffSepConfig = DiffSepConfig()

    # -- type dispatch ------------------------------------------------------
    @property
    def is_matrix(self) -> bool:
        return isinstance(self.sde, MixSDE)  # PriorMixSDE is one too

    @property
    def is_edm(self) -> bool:
        return isinstance(self.sde, SBVESDE)

    def _anchor(self, mix: Tensor, shape: Sequence[int]) -> Tensor:
        """The t=T attractor of the init hacks: mix / n for matrix SDEs,
        the full mixture per source for scalar ones."""
        if self.is_matrix:
            return (mix / shape[1]).expand(shape)
        return mix.expand(shape)

    def model_fwd(self, xt: Tensor, time: Tensor, mix: Tensor,
                  model: Optional[nn.Module] = None, *,
                  lengths: Optional[Tensor] = None) -> Tensor:
        """The score network, under EDM preconditioning for SBVESDE (``c``
        '1' or 'edm', ``network_scaling`` '1/sigma' or '1/t'). ``lengths``
        (B,), each item's valid sample count, goes to a masked score
        model; None keeps the exact reference call."""
        model = self.model if model is None else model

        def call(x, m):
            if lengths is None:
                return model(x, time, m)
            return model(x, time, m, lengths=lengths)

        if not self.is_edm:
            return call(xt, mix)
        cfg, nd = self.cfg, xt.ndim
        sigma = self.sde.std(time)
        sd = cfg.sigma_data
        if cfg.c == "1":
            c_in = c_out = 1.0
            c_skip = 0.0
        elif cfg.c == "edm":
            # as the reference's padded branch: c_in and c_skip swap their
            # roles against Karras et al.
            c_in = bcast_right(sd ** 2 / (sigma ** 2 + sd ** 2), nd)
            c_out = bcast_right(sigma * sd / torch.sqrt(sd ** 2 + sigma ** 2),
                                nd)
            c_skip = bcast_right(sigma ** 2 / (sigma ** 2 + sd ** 2), nd)
        else:
            raise ValueError(f"invalid c: {cfg.c}")
        f = call(c_in * xt, c_in * mix)
        if cfg.network_scaling == "1/sigma":
            f = f / bcast_right(sigma, nd)
        elif cfg.network_scaling == "1/t":
            f = f / bcast_right(time, nd)
        return c_skip * xt + c_out * f

    # -- time sampling ----------------------------------------------------
    def sample_time(self, n: int, *, generator=None, draws: Draws = None,
                    device=None) -> Tensor:
        cfg = self.cfg
        if cfg.time_sampling_strategy == "uniform":
            u = _draw(draws, "time_u", (n,), "uniform", generator, device)
            return torch.clamp(u * (self.sde.T - cfg.t_eps) + cfg.t_eps,
                               min=cfg.t_eps)
        if cfg.time_sampling_strategy == "varprop":
            # the rejection sampler's proposals are not items: the global
            # batch's times are drawn, then the shard's rows kept
            shard = parallel.current_shard()
            n_all = parallel.global_rows(n)
            with parallel.unsharded():
                m = VARPROP_OVERSAMPLE * n_all
                u = _draw(draws, "time_u", (m,), "uniform", generator,
                          device)
                acc = _draw(draws, "time_accept_u", (m,), "uniform",
                            generator, device)
                t = self.sde.sample_time_varprop(generator, n_all,
                                                 cfg.t_eps, u=u,
                                                 accept_u=acc)
            return parallel.take_rows(t, shard)
        raise NotImplementedError(cfg.time_sampling_strategy)

    # -- losses (per-item (B,) values) --------------------------------------
    def compute_score_loss(self, model, mix, target, *, generator=None,
                           draws: Draws = None) -> Tensor:
        """Denoising score matching ||L s_theta + z||^2; with init hack 4
        on a matrix SDE each item is clamped to t=T with probability 1/N
        and its noise target moved to the true-mixture anchor (scalar SDEs
        ignore hack 4, as the reference does)
        (ditsep_tpu/training/diffsep.py:181-214)."""
        cfg, sde, dev = self.cfg, self.sde, target.device
        hack4 = cfg.init_hack == 4 and self.is_matrix
        b = target.shape[0]
        time = self.sample_time(b, generator=generator, draws=draws,
                                device=dev)
        if hack4:
            select = _draw(draws, "select_u", (b,), "uniform", generator,
                           dev) < 1.0 / sde.N
            time = torch.where(select, torch.full_like(time, sde.T), time)
        mean, L = sde.marginal_prob(target, time, mix)
        z = _draw(draws, "z", target.shape, "normal", generator, dev)
        if hack4:
            z_mod = z + sde.mult_std_inv(L, self._anchor(mix, target.shape)
                                         - mean)
            z = torch.where(bcast_right(select, z.ndim), z_mod, z)
        x_t = mean + sde.mult_std(L, z)
        pred = self.model_fwd(x_t, time, mix, model)
        return _batch_mean((sde.mult_std(L, pred) + z) ** 2)

    def compute_score_loss_init_hack_pit(self, model, mix, target, *,
                                         generator=None,
                                         draws: Draws = None) -> Tensor:
        """PIT at t=T: x_t = anchor + L z0, the loss the min over the
        permutations of the target (:216-239); under EDM the noise target
        is z0 itself."""
        sde, dev = self.sde, target.device
        time = torch.full((target.shape[0],), sde.T, dtype=target.dtype,
                          device=dev)
        z0 = _draw(draws, "pit_z", target.shape, "normal", generator, dev)
        anchor = self._anchor(mix, target.shape)
        _, L = sde.marginal_prob(target, time, mix)
        pred = self.model_fwd(anchor + sde.mult_std(L, z0), time, mix, model)
        l_pred = sde.mult_std(L, pred)
        losses = []
        for p in _perms(target.shape[1]):
            mean_p, L_p = sde.marginal_prob(target[:, list(p)], time, mix)
            z_p = (z0 if self.is_edm
                   else z0 + sde.mult_std_inv(L_p, anchor - mean_p))
            losses.append(_batch_mean((l_pred + z_p) ** 2))
        return torch.stack(losses).min(dim=0).values

    def compute_score_loss_with_pit(self, model, mix, target, *,
                                    generator=None,
                                    draws: Draws = None) -> Tensor:
        """mmnr-gated PIT (:241-289), with the reference's sign quirk: the
        noise target adds +L^-1 (mean_p - mean_sel)."""
        cfg, sde, dev = self.cfg, self.sde, target.device
        b, n_src = target.shape[:2]
        time = self.sample_time(b, generator=generator, draws=draws,
                                device=dev)
        perms = _perms(n_src)
        means = torch.stack([sde.marginal_prob(target[:, list(p)], time,
                                               mix)[0]
                             for p in perms], dim=1)  # (B, n_perm, n, T)
        _, L = sde.marginal_prob(target, time, mix)
        z = _draw(draws, "z", target.shape, "normal", generator, dev)
        lz = sde.mult_std(L, z)
        if draws is not None:
            sel = _draw(draws, "sel", (b,), "int", generator, dev).long()
        else:
            sel = parallel.draw_rows(lambda s: torch.randint(
                0, len(perms), s, generator=generator, device=dev), (b,))
        mean_sel = means[torch.arange(b, device=dev), sel]
        x_t = mean_sel + lz
        err = means - mean_sel[:, None]
        n_elems = (len(perms) - 1) * math.prod(target.shape[1:])
        err_pow = (err ** 2).sum(dim=tuple(range(1, err.ndim))) / n_elems
        noise_pow = _batch_mean(lz ** 2)
        mmnr = 10.0 * torch.log10(err_pow / torch.clamp(noise_pow, min=1e-5))
        use_pit = mmnr < cfg.mmnr_thresh_pit
        l_pred = sde.mult_std(L, self.model_fwd(x_t, time, mix, model))
        losses = [_batch_mean((l_pred + z + sde.mult_std_inv(L, err[:, i]))
                              ** 2) for i in range(len(perms))]
        loss_pit = torch.stack(losses).min(dim=0).values
        loss_reg = _batch_mean((l_pred + z) ** 2)
        return torch.where(use_pit, loss_pit, loss_reg)

    def compute_score_loss_with_pit_allthetime(self, model, mix, target, *,
                                               generator=None,
                                               draws: Draws = None
                                               ) -> Tensor:
        """All-time PIT (:291-308): shuffled sources, one forward, the min
        over the permutations of the noise target."""
        sde, dev = self.sde, target.device
        time = self.sample_time(target.shape[0], generator=generator,
                                draws=draws, device=dev)
        target = sep_utils.shuffle_sources(target, u=_draw(
            draws, "shuffle_u", target.shape[:2], "uniform", generator, dev))
        mean_0, L = sde.marginal_prob(target, time, mix)
        z0 = _draw(draws, "z", target.shape, "normal", generator, dev)
        pred = self.model_fwd(mean_0 + sde.mult_std(L, z0), time, mix, model)
        l_pred = sde.mult_std(L, pred)
        losses = []
        for p in _perms(target.shape[1]):
            mean_p, _ = sde.marginal_prob(target[:, list(p)], time, mix)
            z_p = z0 + sde.mult_std_inv(L, mean_0 - mean_p)
            losses.append(_batch_mean((l_pred + z_p) ** 2))
        return torch.stack(losses).min(dim=0).values

    def _shuffled(self, loss_fn):
        """``loss_fn`` on the target with its sources shuffled first."""
        def loss(model, mix, target, *, generator=None, draws=None):
            u = _draw(draws, "shuffle_u", target.shape[:2], "uniform",
                      generator, target.device)
            return loss_fn(model, mix, sep_utils.shuffle_sources(target, u=u),
                           generator=generator, draws=draws)
        return loss

    def _mixture_loss(self, model, mix, target, other_loss, *,
                      generator=None, draws: Draws = None) -> Tensor:
        """Per item, with probability init_hack_p the t=T PIT loss, else
        ``other_loss``; both run on the whole batch (:311-324)."""
        b = mix.shape[0]
        pit_mask = _draw(draws, "mask_u", (b,), "uniform", generator,
                         mix.device) < self.cfg.init_hack_p
        loss_pit = self.compute_score_loss_init_hack_pit(
            model, mix, target, generator=generator, draws=draws)
        loss_other = other_loss(model, mix, target, generator=generator,
                                draws=draws)
        return torch.where(pit_mask, loss_pit, loss_other)

    def training_loss(self, model, mix, target, *, generator=None,
                      draws: Draws = None) -> Tensor:
        """Scalar training loss (:326-364)."""
        cfg = self.cfg
        kw = dict(generator=generator, draws=draws)
        if cfg.init_hack in (5, 6, 7):
            other = {5: self._shuffled(self.compute_score_loss),
                     6: self._shuffled(self.compute_score_loss_with_pit),
                     7: self.compute_score_loss_with_pit_allthetime
                     }[cfg.init_hack]
            loss = self._mixture_loss(model, mix, target, other, **kw)
        elif cfg.train_source_order == "pit":
            loss = self.compute_score_loss_with_pit(model, mix, target, **kw)
        else:
            if cfg.train_source_order == "power":
                target = sep_utils.power_order_sources(target)
            elif cfg.train_source_order == "random":
                target = sep_utils.shuffle_sources(target, u=_draw(
                    draws, "shuffle_u", target.shape[:2], "uniform",
                    generator, target.device))
            loss = self.compute_score_loss(model, mix, target, **kw)
        return loss.mean()

    # -- optimizer / train step ---------------------------------------------
    def make_optimizer(self, model: Optional[nn.Module] = None) -> ClipAdam:
        cfg = self.cfg
        model = self.model if model is None else model
        return ClipAdam(model.parameters(), cfg.lr, cfg.grad_clip,
                        cfg.lr_warmup, cfg.accumulate_grad_batches)

    def init_state(self, model: Optional[nn.Module] = None) -> TrainState:
        """A fresh TrainState around ``model`` (the trainer's by default),
        the EMA a copy of it."""
        model = self.model if model is None else model
        ema = copy.deepcopy(model).eval().requires_grad_(False)
        return TrainState(step=0, model=model,
                          optimizer=self.make_optimizer(model), ema=ema)

    def _check_trainable(self, model: nn.Module) -> None:
        for m in model.modules():
            if isinstance(m, nn.Dropout) and m.p > 0:
                raise NotImplementedError(
                    "training with dropout > 0 is not ported yet (it would "
                    "draw from the global generator)")

    def train_step(self, state: TrainState, batch: Tuple[Tensor, Tensor], *,
                   generator: Optional[torch.Generator] = None,
                   draws: Draws = None, mesh=None) -> Tuple[TrainState, Dict]:
        """One step: normalize -> loss -> grad -> clip -> Adam -> EMA. The
        parameters and the EMA are updated in place; the metrics are
        tensors on the device (reading them syncs). With ``mesh``
        (``parallel.make_mesh``), ``batch`` is this rank's rows of the
        global batch, the draws are the global batch's, and the step is
        the global batch's (the gradient averaged over the ranks before
        the clip; the metrics averaged too)."""
        (mix, target), _, _ = sep_utils.normalize_batch(batch)
        return self._apply_step(state, mix, target, generator=generator,
                                draws=draws, mesh=mesh)

    def _apply_step(self, state: TrainState, mix: Tensor, target: Tensor, *,
                    generator=None, draws: Draws = None, mesh=None
                    ) -> Tuple[TrainState, Dict]:
        """loss -> grad -> [all-reduce] -> clip -> Adam -> EMA on a
        prepared batch. Every loss is a mean of per-item values, so the
        mean of the ranks' equal shards is the global batch's."""
        model = state.model
        self._check_trainable(model)
        params = list(model.parameters())
        with _mode(model, True), torch.enable_grad(), \
                parallel.sharded(mesh):
            loss = self.training_loss(model, mix, target, generator=generator,
                                      draws=draws)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = parallel.all_reduce_mean_(loss.detach(), mesh)
        parallel.all_reduce_grads_(grads, mesh)
        with torch.no_grad():
            grad_norm = global_norm(grads)
            state.optimizer.step(grads)
            ema_update_(state.ema, model, self.cfg.ema_decay)
        state.step += 1
        return state, {"train/score_loss": loss,
                       "train/grad_norm": grad_norm}

    # -- validation / inference ---------------------------------------------
    @torch.no_grad()
    def val_score_loss(self, model, batch, *, generator=None,
                       draws: Draws = None, mesh=None) -> Tensor:
        """The training loss in eval mode; with ``mesh`` the global
        batch's (this rank holds its rows)."""
        (mix, target), _, _ = sep_utils.normalize_batch(batch)
        model = self.model if model is None else model
        with _mode(model, False), parallel.sharded(mesh):
            loss = self.training_loss(model, mix, target,
                                      generator=generator, draws=draws)
        return parallel.all_reduce_mean_(loss, mesh)

    @torch.no_grad()
    def separate(self, mix: Tensor, *, N: Optional[int] = None,
                 snr: Optional[float] = None,
                 corrector_steps: Optional[int] = None,
                 sampler: str = "pc", lengths: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence] = None,
                 model: Optional[nn.Module] = None) -> Tuple[Tensor, int]:
        """Normalize -> reverse sampling -> denormalize. ``mix`` is (B, 1,
        T) on the model's device. The sampler follows the SDE, as the
        reference's: the Schroedinger-bridge sampler for SBVESDE (its
        ``sampler_type``; ``sampler``, ``snr`` and ``corrector_steps`` do
        not apply), else PC with the reverse-diffusion predictor and the
        ald2 (matrix SDEs) or ald (scalar) corrector, or with ``sampler=
        'ab2'`` the Adams-Bashforth integrator (one score evaluation a
        step). ``noise`` is the chosen sampler's explicit draws (see its
        docstring). With ``lengths`` (B,), each item's valid sample count,
        the normalization takes each item's valid samples only and every
        score call gets the lengths (masked scoring). Returns (estimates
        (B, n_speakers, T), nfe)."""
        if sampler not in ("pc", "ab2"):
            raise ValueError(f"unknown sampler {sampler!r}")
        cfg = self.cfg
        (mix, _), mean, std = sep_utils.normalize_batch((mix, None),
                                                        lengths=lengths)
        score_fn = lambda x, t, y: self.model_fwd(  # noqa: E731
            x, t, y, model, lengths=lengths)
        kw = dict(n_spkrs=cfg.n_speakers, generator=generator, noise=noise)
        if self.is_edm:
            sde = self.sde if N is None else dataclasses.replace(self.sde,
                                                                 N=N)
            est, nfe = sb_sample(sde, score_fn, mix,
                                 sampler_type=sde.sampler_type, **kw)
        elif sampler == "ab2":
            est, nfe = ab2_sample(self.sde, score_fn, mix,
                                  N=cfg.sampler_N if N is None else N,
                                  eps=cfg.t_eps, **kw)
        else:
            est, nfe = pc_sample(
                self.sde, score_fn, mix, predictor="reverse_diffusion",
                corrector="ald2" if self.is_matrix else "ald",
                N=cfg.sampler_N if N is None else N,
                snr=cfg.sampler_snr if snr is None else snr,
                corrector_steps=(cfg.sampler_corrector_steps
                                 if corrector_steps is None
                                 else corrector_steps),
                denoise=True, eps=cfg.t_eps, **kw)
        return sep_utils.denormalize_batch(est, mean, std), nfe

    def separate_minibatched(self, mix: Tensor, *, max_batch: int = 4,
                             lengths: Optional[Tensor] = None,
                             **kwargs) -> Tuple[Tensor, int]:
        """``separate`` in chunks of ``max_batch`` items, bounding memory
        (ditsep_tpu/training/diffsep.py:474-494): the last chunk is filled
        up by repeating its last item (and its length) and trimmed, so
        every call has one shape. ``kwargs`` go to every call, the
        generator drawn from in turn."""
        nfe, outs = 0, []
        for start in range(0, mix.shape[0], max_batch):
            chunk = mix[start:start + max_batch]
            lens = None if lengths is None else lengths[start:start
                                                        + max_batch]
            n_real = chunk.shape[0]
            if n_real < max_batch:
                reps = max_batch - n_real
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (reps,) + tuple(chunk.shape[1:]))])
                if lens is not None:
                    lens = torch.cat([lens, lens[-1:].expand(reps)])
            est, nfe = self.separate(chunk, lengths=lens, **kwargs)
            outs.append(est[:n_real])
        return torch.cat(outs), nfe

    def val_separation_metrics(self, model, batch, *, generator=None,
                               mesh=None, return_est: bool = False):
        """Separation + SI-SDR for validation monitoring (:496-508); with
        ``mesh`` the global batch's (this rank holds its rows). Returns the
        metrics dict, and with ``return_est`` (metrics, this rank's
        estimates) for the validation media."""
        mix, target = batch
        with parallel.sharded(mesh):
            est, _ = self.separate(mix, generator=generator, model=model)
        si_sdr = loss_lib.si_sdr_loss(est, target, zero_mean=True,
                                      clamp_db=30.0)
        metrics = {"val/si_sdr": parallel.all_reduce_mean_(si_sdr, mesh)}
        return (metrics, est) if return_est else metrics
