"""The training loop: ``fit`` drives train steps over bucketed data (the
port's ditsep_tpu/training/loop.py), on one device or data-parallel over
a mesh.

Epochs over a ``BucketedLoader``; scalars every ``log_every`` steps to
``metrics.jsonl`` (and TensorBoard, ``utils/logging.py``); after each
step the callbacks that are due (the demo separations, ``training/
demo.py``); at each epoch's end a validation (the score loss over every
validation batch, weighted by its real item count, and up to
``valid_max_sep_batches`` separations on the EMA weights scored by
SI-SDR, the first one's item 0 logged as audio and a spectrogram
figure), a top-k checkpoint on val/si_sdr and the rolling latest one; an
emergency latest checkpoint when training raises; at the end the EMA
weights as ``ema.npz`` in the JAX package's flat layout. A media call
that fails is printed and counted, as the JAX loop goes on past it; the
returned state's ``media_failures`` holds the count. A callback's own
work is not guarded: the demo separation that fails stops the run.

With a ``mesh`` (``parallel.make_mesh`` under a process group) every rank
builds the same loaders with the same seed, so all ranks see the same
global batches, and takes its rows of each; the steps and the validation
are the global batch's (the trainers reduce over the ranks). Rank 0
alone writes the run config, the logs, the checkpoints and ``ema.npz``
(ditsep_tpu/training/loop.py:74-79); every rank restores on resume.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ditsep_tpu_torch import viz
from ditsep_tpu_torch.data.wsj0_mix import BucketedLoader
from ditsep_tpu_torch.models.weights import save_params_npz
from ditsep_tpu_torch.parallel import (
    check_one_device_a_rank, is_rank_zero, shard_batch,
)
from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from ditsep_tpu_torch.utils.logging import MetricsLogger

EMA_EXPORT = "ema.npz"
N_BUCKETS, BUCKET_MULTIPLE = 6, 4096  # the train loader's length buckets


def _save_run_config(workdir: str, trainer) -> None:
    """``hparams.json``: the trainer config, the SDE and the score model's
    scalar settings."""
    model = trainer.model
    rec = {"trainer_cfg": dataclasses.asdict(trainer.cfg),
           "sde": {"kind": type(trainer.sde).__name__,
                   **dataclasses.asdict(trainer.sde)},
           "model": {k: v for k, v in vars(model).items()
                     if not k.startswith("_")
                     and isinstance(v, (int, float, str, bool, tuple, list))}}
    Path(workdir).mkdir(parents=True, exist_ok=True)
    with open(Path(workdir) / "hparams.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)


def fit(trainer, train_dataset, val_dataset=None, *, workdir: str,
        max_epochs: int = 1000, batch_size: int = 16, seed: int = 0,
        valid_max_sep_batches: int = 2, log_every: int = 10,
        resume: bool = False, max_steps: Optional[int] = None, mesh=None,
        log_media: bool = True, media_fs: int = 8000, callbacks: tuple = ()):
    """Train ``trainer`` (a DiffSepTrainer, or anything with its
    ``model``, ``cfg``, ``sde``, ``init_state``, ``train_step``,
    ``val_score_loss`` and ``val_separation_metrics``, each taking
    ``mesh=``, the last ``return_est=`` too) on its model's device;
    returns the final TrainState. Random draws come from one generator on
    that device, seeded with ``seed``; each callback that is due takes one
    draw of it, the seed of its own generator. ``batch_size`` is the
    global batch: with ``mesh`` it must split over the ranks.
    ``callbacks`` expose ``due(step)`` and ``__call__(logger, step,
    trainer, state, generator)``; ``log_media`` logs the validation media
    at ``media_fs``."""
    check_one_device_a_rank(mesh, "training")
    rank_zero = is_rank_zero()
    logger = MetricsLogger(workdir, enabled=rank_zero)
    ckpt = CheckpointManager(f"{workdir}/checkpoints", write=rank_zero)
    if rank_zero:
        _save_run_config(workdir, trainer)
    device = next(trainer.model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    state = trainer.init_state()
    if resume:
        try:
            state = ckpt.restore(state, prefer="latest")
        except FileNotFoundError:
            pass
    loader = BucketedLoader(train_dataset, batch_size=batch_size,
                            n_buckets=N_BUCKETS, multiple=BUCKET_MULTIPLE,
                            shuffle=True, seed=seed)
    val_loader = None
    if val_dataset is not None:
        # validation pads within each item's own 64-frame STFT block, all
        # padding trailing, as the model sees items at native length; a
        # latent model (no STFT) takes sample-domain buckets
        m = trainer.model
        frame_spec = ((m.n_fft, m.hop_length, 64) if hasattr(m, "n_fft")
                      else None)
        val_loader = BucketedLoader(
            val_dataset, batch_size=batch_size, n_buckets=2,
            multiple=BUCKET_MULTIPLE, shuffle=False, frame_spec=frame_spec,
            align="left", yield_counts=True)
    try:
        _train_epochs(trainer, state, loader, val_loader, generator, device,
                      logger, ckpt, max_epochs, max_steps, log_every,
                      valid_max_sep_batches, seed, mesh, log_media, media_fs,
                      callbacks)
    except Exception:
        # a crash loses nothing past the last step (the state is updated
        # in place); a failing save must not hide the crash
        try:
            ckpt.save_latest(state, state.step)
        except Exception:
            pass
        raise
    logger.close()
    state.media_failures = logger.failures
    if rank_zero:
        save_params_npz(str(Path(workdir) / EMA_EXPORT), state.ema)
    return state


def _to_device(batch, device, mesh=None):
    """The batch's arrays as tensors on ``device``; with ``mesh`` this
    rank's rows."""
    if mesh is not None:
        return tuple(shard_batch(mesh, tuple(batch)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in batch)


def _log_val_media(logger, batch, est, step: int, fs: int) -> None:
    """The first validation item: its mixture and estimates as audio and,
    where matplotlib is installed, a spectrogram grid of the mixture, the
    estimates and the targets."""
    mix = batch[0][0].float().cpu().numpy().reshape(-1)
    tgt = batch[1][0].float().cpu().numpy()
    e = est[0].float().cpu().numpy()
    logger.log_audio("val/mix", mix, step, fs)
    for i in range(e.shape[0]):
        logger.log_audio(f"val/est_{i}", e[i], step, fs)
    if viz.available():
        logger.log_figure("val/spectrograms",
                          viz.separation_figure(mix, e, tgt, fs=fs), step)


def _callback_generator(generator: torch.Generator) -> torch.Generator:
    """A generator on ``generator``'s device seeded by one draw of it."""
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device).item()
    return torch.Generator(device=generator.device).manual_seed(seed)


def _train_epochs(trainer, state, loader, val_loader, generator, device,
                  logger, ckpt, max_epochs, max_steps, log_every,
                  valid_max_sep_batches, seed, mesh, log_media, media_fs,
                  callbacks) -> None:
    stop = False
    for epoch in range(max_epochs):
        loader.seed = seed + epoch
        for batch in loader:
            state, metrics = trainer.train_step(
                state, _to_device(batch, device, mesh), generator=generator,
                mesh=mesh)
            if state.step % log_every == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           state.step)
            for cb in callbacks:
                if cb.due(state.step):
                    cb(logger, state.step, trainer, state,
                       _callback_generator(generator))
            if max_steps is not None and state.step >= max_steps:
                stop = True
                break

        val_metrics: Dict[str, float] = {}
        if val_loader is not None:
            losses, weights, si_sdrs, sep_weights = [], [], [], []
            for mix_b, tgt_b, n_real in val_loader:
                batch = _to_device((mix_b, tgt_b), device, mesh)
                losses.append(float(trainer.val_score_loss(
                    state.model, batch, generator=generator, mesh=mesh)))
                weights.append(n_real)
                if len(si_sdrs) < valid_max_sep_batches:
                    media = not si_sdrs and log_media and logger.enabled
                    m = trainer.val_separation_metrics(
                        state.ema, batch, generator=generator, mesh=mesh,
                        return_est=media)
                    if media:
                        m, est = m
                        logger.guarded("fit: validation media", state.step,
                                       _log_val_media, logger, batch, est,
                                       state.step, media_fs)
                    si_sdrs.append(float(m["val/si_sdr"]))
                    sep_weights.append(n_real)
            # weighted by real item counts: remainder batches are filled
            # by cycling their real items
            if losses:
                val_metrics["val/score_loss"] = float(
                    np.average(losses, weights=weights))
            if si_sdrs:
                val_metrics["val/si_sdr"] = float(
                    np.average(si_sdrs, weights=sep_weights))
            logger.log(val_metrics, state.step)
            ckpt.save(state, state.step, val_metrics)
        ckpt.save_latest(state, state.step)
        if stop:
            break
