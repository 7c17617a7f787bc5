"""Diffusion training for the stable-audio generative models: the
v-objective and rectified flow, conditional and unconditional, the
inpainting and mono-to-stereo prior variants, and the diffusion
autoencoder's joint training (port of ditsep_tpu/training/diffusion.py;
reference: stable-audio-tools training/diffusion.py:215-560 Diffusion
{Uncond,Cond}TrainingWrapper, create_source_mixture :1408-1429).

Conditioning tensors come from a MultiConditioner and are routed by the
cond-id lists (``CondRouting``), as the model factory builds them for
generation.

Every draw is explicit: from ``generator`` (a ``torch.Generator``), or
from ``draws`` by role, the raw arrays the JAX code draws, to which the
port applies the JAX code's transforms:

* ``t`` (B,) the timestep draw: uniforms for the 'uniform' sampler,
  standard normals for 'logit_normal' and 'trunc_logit_normal';
* ``noise`` x0's shape, standard normals;
* ``cfg_cross`` and ``cfg_prepend`` (B, 1, 1) uniforms of the DiT's CFG
  dropout (the JAX DiT's split of its ``rngs_key``); another net's
  ``cfg_drop`` (B,) uniforms, a row dropped below the probability;
* the inpainting mask's integers: ``mask_type`` (B,) in [0, 3),
  ``n_segments`` (B,) in [1, max_mask_segments], and the raw draws in
  [0, 2^31 - 1) that the JAX code takes modulo a length, ``seg_len`` and
  ``seg_start`` (B, max_mask_segments) and ``causal_len`` (B,);
* the source mixture's integers: ``shifts`` (num_sources,) in [0, B) and
  ``offsets`` (B, num_sources) in [0, T).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch.inference.sampling import (
    get_alphas_sigmas, truncated_logistic_normal_rescaled,
)
from ditsep_tpu_torch.training.diffsep import (
    Draws, TrainState, _draw, ema_update_, global_norm,
)
from ditsep_tpu_torch.training.schedules import adamw

Tensor = torch.Tensor
INT32_MAX = 2 ** 31 - 1

# the JAX package's DiffusionTrainState has TrainState's fields: the step,
# the model (its parameters), the optimizer and the EMA copy
DiffusionTrainState = TrainState


def sample_timesteps(n: int, sampler: str = "uniform", *,
                     generator: Optional[torch.Generator] = None,
                     draws: Draws = None, device=None) -> Tensor:
    """(n,) timesteps of the uniform / logit_normal / trunc_logit_normal
    samplers (reference: training/diffusion.py:364-376), from the raw
    draw ``t`` (uniforms, or normals for the logit samplers), on
    ``device`` (None: the generator's, or the draw's own)."""
    if device is None and generator is not None:
        device = generator.device
    if sampler == "uniform":
        return _draw(draws, "t", (n,), "uniform", generator, device)
    if sampler == "logit_normal":
        return torch.sigmoid(_draw(draws, "t", (n,), "normal", generator,
                                   device))
    if sampler == "trunc_logit_normal":
        return 1.0 - truncated_logistic_normal_rescaled(
            (n,), normal=_draw(draws, "t", (n,), "normal", generator,
                               device))
    raise ValueError(f"Invalid timestep_sampler: {sampler}")


def diffusion_targets(objective: str, x0: Tensor, noise: Tensor,
                      t: Tensor) -> Tuple[Tensor, Tensor]:
    """(noised input, target) of the objective (reference: training/
    diffusion.py:383-399): 'v' on the cosine schedule, or
    'rectified_flow'."""
    if objective == "v":
        alphas, sigmas = get_alphas_sigmas(t)
    elif objective == "rectified_flow":
        alphas, sigmas = 1.0 - t, t
    else:
        raise ValueError(objective)
    shape = (-1,) + (1,) * (x0.ndim - 1)
    alphas, sigmas = alphas.reshape(shape), sigmas.reshape(shape)
    noised = x0 * alphas + noise * sigmas
    if objective == "v":
        return noised, noise * alphas - x0 * sigmas
    return noised, noise - x0


def create_source_mixture(reals: Tensor, num_sources: int = 2, *,
                          generator: Optional[torch.Generator] = None,
                          draws: Draws = None) -> Tuple[Tensor, Tensor]:
    """Fake mixtures: the sum of ``num_sources`` batch rows, each shifted
    right by its offset with zeros before it (reference: training/
    diffusion.py:1408-1429, shape-static as the JAX package's). Donor s of
    row i is row (i - shifts[s]) mod B, row i itself for s = 0. Returns
    (the mixture, the s = 0 contribution: the true source, aligned)."""
    b, c, t = reals.shape
    offsets = _draw(draws, "offsets", (b, num_sources), "int", generator,
                    reals.device, 0, t)
    shifts = _draw(draws, "shifts", (num_sources,), "int", generator,
                   reals.device, 0, b)
    pos = torch.arange(t, device=reals.device)
    rows = torch.arange(b, device=reals.device)
    source, new_reals = torch.zeros_like(reals), reals
    for s in range(num_sources):
        donor = torch.remainder(rows - shifts[s], b) if s > 0 else rows
        off = offsets[:, s:s + 1]
        idx = torch.remainder(pos[None] - off, t)[:, None].expand(b, c, t)
        keep = (pos[None] >= off).to(reals.dtype)[:, None]
        contrib = reals[donor].gather(-1, idx) * keep
        source = source + contrib
        if s == 0:
            new_reals = contrib
    return source, new_reals


def random_inpaint_mask(x: Tensor, max_mask_segments: int = 10,
                        padding_mask: Optional[Tensor] = None, *,
                        generator: Optional[torch.Generator] = None,
                        draws: Draws = None) -> Tuple[Tensor, Tensor]:
    """The inpainting mask of the reference's random_mask (reference:
    training/diffusion.py:848-895), shape-static as the JAX package's: per
    item one of multi-segment (type 0), full (1) or causal (2), never over
    padding. The segments are ``max_mask_segments`` candidate (start,
    length) pairs, the first ``n_segments`` active. Returns (x * mask,
    mask (B, 1, T)), 1 keep and 0 regenerate for the segment masks."""
    b, _, t = x.shape
    dev = x.device

    def src(name, shape, low, high):
        return _draw(draws, name, shape, "int", generator, dev, low, high)
    pos = torch.arange(t, device=dev)
    if padding_mask is None:
        real_len = torch.full((b,), t, dtype=torch.long, device=dev)
    else:
        real_len = padding_mask.to(dev, torch.long).sum(-1).clamp_min(1)
    s = max_mask_segments
    mask_type = src("mask_type", (b,), 0, 3)
    nseg = src("n_segments", (b,), 1, s + 1)
    max_seg = (real_len[:, None] // nseg[:, None]).clamp_min(1)
    seg_len = src("seg_len", (b, s), 0, INT32_MAX) % max_seg + 1
    start = src("seg_start", (b, s), 0, INT32_MAX) % (
        real_len[:, None] - seg_len + 1).clamp_min(1)
    active = torch.arange(s, device=dev)[None] < nseg[:, None]
    in_seg = ((pos >= start[..., None]) & (pos < (start + seg_len)[..., None])
              & active[..., None])
    seg_mask = 1.0 - in_seg.any(dim=1).to(x.dtype)
    causal_len = src("causal_len", (b,), 0, INT32_MAX) % real_len + 1
    causal_mask = (pos[None] < causal_len[:, None]).to(x.dtype)
    mt = mask_type[:, None]
    mask = torch.where(mt == 0, seg_mask, torch.where(
        mt == 1, torch.zeros_like(seg_mask), causal_mask))[:, None]
    return x * mask, mask


@dataclasses.dataclass(frozen=True)
class CondRouting:
    """Which conditioner outputs feed which model input (reference:
    models/diffusion.py:112-214): ``gather(cond)`` concatenates the named
    (embedding, mask) pairs into the DiT's keyword arguments."""

    cross_attn_cond_ids: Tuple[str, ...] = ()
    global_cond_ids: Tuple[str, ...] = ()
    input_concat_ids: Tuple[str, ...] = ()
    prepend_cond_ids: Tuple[str, ...] = ()

    def gather(self, cond: Dict[str, Tuple[Tensor, Tensor]]
               ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.cross_attn_cond_ids:
            out["cross_attn_cond"] = torch.cat(
                [cond[k][0] for k in self.cross_attn_cond_ids], dim=1)
            out["cross_attn_cond_mask"] = torch.cat(
                [cond[k][1] for k in self.cross_attn_cond_ids], dim=1)
        if self.global_cond_ids:
            out["global_embed"] = torch.cat(
                [cond[k][0].reshape(cond[k][0].shape[0], -1)
                 for k in self.global_cond_ids], dim=-1)
        if self.input_concat_ids:
            out["input_concat_cond"] = torch.cat(
                [cond[k][0] for k in self.input_concat_ids], dim=1)
        if self.prepend_cond_ids:
            out["prepend_cond"] = torch.cat(
                [cond[k][0] for k in self.prepend_cond_ids], dim=1)
            out["prepend_cond_mask"] = torch.cat(
                [cond[k][1] for k in self.prepend_cond_ids], dim=1)
        return out


def init_train_state(model: nn.Module, optimizer) -> TrainState:
    """A fresh state: ``model`` trainable, ``optimizer`` built on its
    parameters, the EMA a frozen copy."""
    model.requires_grad_(True)
    return TrainState(step=0, model=model,
                      optimizer=optimizer(model.parameters()),
                      ema=copy.deepcopy(model).requires_grad_(False))


def model_grads(loss_fn, model: nn.Module) -> Tuple[Tensor, list]:
    """(loss, d loss / d each parameter of ``model``, zeros where
    unused) of ``loss_fn()``."""
    params = list(model.parameters())
    with torch.enable_grad():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g
                  for p, g in zip(params, grads)]


def apply_gradient_update(state: TrainState, loss: Tensor, grads: list,
                          ema_decay: float) -> Tuple[TrainState, Dict]:
    """The shared tail of every diffusion and LM train step: the
    optimizer's update, the EMA, the step, and the metrics ``train/loss``
    and ``train/grad_norm`` (the global norm before any clip)."""
    norm = global_norm(grads)
    state.optimizer.step(grads)
    ema_update_(state.ema, state.model, ema_decay)
    state.step += 1
    return state, {"train/loss": loss.detach(), "train/grad_norm": norm}


@dataclasses.dataclass(frozen=True)
class DiffusionTrainer:
    """v / rectified-flow diffusion training of a DiT-style net
    ``model(x, t, **cond_inputs)`` that predicts the objective's target;
    unconditional when ``routing`` is None (reference: Diffusion{Uncond,
    Cond}TrainingWrapper :215-560). ``inpaint`` trains with a random keep
    mask (the masked input and the mask feed the net through the
    ``inpaint_*`` ids; DiffusionCondInpaintTrainingWrapper :757-1010);
    ``mono_stereo_prior`` conditions on the channel mean of the target
    under the ``source`` id (DiffusionPriorTrainingWrapper :1431-1580).
    The optimizer is AdamW(lr, 0.9, 0.999, wd 1e-3)."""

    model: nn.Module
    objective: str = "v"
    timestep_sampler: str = "uniform"
    lr: float = 1e-4
    ema_decay: float = 0.9999
    cfg_dropout_prob: float = 0.1
    routing: Optional[CondRouting] = None
    inpaint: bool = False
    max_mask_segments: int = 10
    mono_stereo_prior: bool = False

    def make_optimizer(self, params):
        return adamw(params, self.lr, 0.9, 0.999, 1e-3)

    def init_state(self) -> TrainState:
        return init_train_state(self.model, self.make_optimizer)

    def _cfg_dropout(self, net: nn.Module, draw, b: int) -> Dict[str, Any]:
        from ditsep_tpu_torch.models.dit import DiffusionTransformer
        p = self.cfg_dropout_prob
        if isinstance(net, DiffusionTransformer):
            return {"cfg_dropout_prob": p, "cfg_dropout_uniform": (
                draw("cfg_cross", (b, 1, 1)), draw("cfg_prepend", (b, 1, 1)))}
        return {"cfg_dropout_prob": p, "cfg_drop": draw("cfg_drop", (b,)) < p}

    def loss(self, x0: Tensor, cond: Optional[Dict] = None,
             padding_mask: Optional[Tensor] = None, *,
             model: Optional[nn.Module] = None,
             generator: Optional[torch.Generator] = None,
             draws: Draws = None) -> Tensor:
        """The objective's mean squared error (over the unpadded samples
        with ``padding_mask`` (B, T))."""
        net = self.model if model is None else model
        b = x0.shape[0]
        t = sample_timesteps(b, self.timestep_sampler, generator=generator,
                             draws=draws, device=x0.device)
        noise = _draw(draws, "noise", x0.shape, "normal", generator,
                      x0.device).to(x0.dtype)
        noised, target = diffusion_targets(self.objective, x0, noise, t)
        if self.inpaint:
            masked, mask = random_inpaint_mask(
                x0, self.max_mask_segments, padding_mask,
                generator=generator, draws=draws)
            cond = {**(cond or {}), "inpaint_mask": (mask, None),
                    "inpaint_masked_input": (masked, None)}
        if self.mono_stereo_prior:
            source = x0.mean(dim=1, keepdim=True).expand_as(x0)
            cond = {**(cond or {}), "source": (source, None)}
        kwargs: Dict[str, Any] = {}
        if cond is not None and self.routing is not None:
            kwargs = self.routing.gather(cond)
            if self.cfg_dropout_prob > 0:
                kwargs.update(self._cfg_dropout(net, lambda name, shape: _draw(
                    draws, name, shape, "uniform", generator, x0.device), b))
        se = (net(noised, t, **kwargs) - target) ** 2
        if padding_mask is None:
            return se.mean()
        m = padding_mask[:, None, :].to(se.dtype)
        return (se * m).sum() / m.expand_as(se).sum().clamp_min(1.0)

    def train_step(self, state: TrainState, x0: Tensor,
                   cond: Optional[Dict] = None,
                   padding_mask: Optional[Tensor] = None, *,
                   generator: Optional[torch.Generator] = None,
                   draws: Draws = None) -> Tuple[TrainState, Dict]:
        loss, grads = model_grads(lambda: self.loss(
            x0, cond, padding_mask, model=state.model, generator=generator,
            draws=draws), state.model)
        return apply_gradient_update(state, loss, grads, self.ema_decay)


@dataclasses.dataclass(frozen=True)
class DiffAETrainer:
    """Joint encoder and diffusion-decoder training of a
    ``DiffusionAutoencoder`` (reference: DiffusionAutoencoderTraining
    Wrapper, factory.py:119-136): v-objective reconstruction, the net
    conditioned on the nearest-upsampled encoder latents by input
    concatenation; both parts take gradients."""

    model: nn.Module
    lr: float = 1e-4
    ema_decay: float = 0.9999
    timestep_sampler: str = "uniform"

    def make_optimizer(self, params):
        return adamw(params, self.lr, 0.9, 0.999, 1e-3)

    def init_state(self) -> TrainState:
        return init_train_state(self.model, self.make_optimizer)

    def loss(self, x0: Tensor, *, model: Optional[nn.Module] = None,
             generator: Optional[torch.Generator] = None,
             draws: Draws = None) -> Tensor:
        ae = self.model if model is None else model
        t = sample_timesteps(x0.shape[0], self.timestep_sampler,
                             generator=generator, draws=draws,
                             device=x0.device)
        latents = ae.encode(x0)
        noise = _draw(draws, "noise", x0.shape, "normal", generator,
                      x0.device).to(x0.dtype)
        noised, target = diffusion_targets("v", x0, noise, t)
        return ((ae.diffusion_input(noised, t, latents) - target) ** 2).mean()

    def train_step(self, state: TrainState, x0: Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   draws: Draws = None) -> Tuple[TrainState, Dict]:
        loss, grads = model_grads(lambda: self.loss(
            x0, model=state.model, generator=generator, draws=draws),
            state.model)
        return apply_gradient_update(state, loss, grads, self.ema_decay)
