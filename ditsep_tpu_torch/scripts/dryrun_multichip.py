"""Every trainer family's data-parallel step over N ranks, plus the
sharded sampler and the evaluation harness (port of
__graft_entry__.dryrun_multichip and its legs ``_leg_diffsep``,
``_leg_latent``, ``_leg_ldm``, ``_leg_vaegan``):

1. diffsep: a MixSDE train step, the PC sampler on the rows of each rank,
   and ``eval.evaluate_dataset`` over 5 items (not a multiple of N);
2. latent: a ``train_step_latent`` (frozen-VAE encode + latent loss);
3. LDM: a decoder gen step (PIT-MRSTFT + adversarial + feature matching)
   and a discriminator step;
4. VAE-GAN: an ``AutoencoderTrainer`` gen step and a disc step.

Models are tiny; every global batch is 2 items a rank, split over the
ranks, the parameters replicated. Each leg returns what it computed, so
that a check can hold an N-rank run against the one-process run on the
same global batch (``mesh=None``).

    python -m ditsep_tpu_torch.scripts.dryrun_multichip --nproc 2 \\
        --backend gloo --cpu
    python -m ditsep_tpu_torch.scripts.dryrun_multichip --nproc 1 \\
        --backend nccl          # one card a rank
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.configs import (
    build_diffsep_trainer, build_latent_trainer, diffsep,
    latent_diffsep_ouve, override,
)

ROWS = 2  # items a rank
DIFFSEP_TINY = {"model.score_model.nf": 8,
                "model.score_model.ch_mult": (1, 2),
                "model.score_model.num_res_blocks": 1,
                "model.score_model.attn_resolutions": (),
                "model.init_hack": 5, "model.lr": 1e-3}
LATENT_TINY = {"model.score_model.nf": 16,
               "model.score_model.ch_mult": (1, 2),
               "model.score_model.attn_resolutions": (),
               "model.score_model.image_size": 4,
               "model.vae.channels": 8, "model.vae.c_mults": (1, 2),
               "model.vae.strides": (2, 4), "model.vae.latent_dim": 4,
               "model.init_hack": 5, "model.lr": 1e-3}


def _device(mesh) -> torch.device:
    return torch.device("cpu") if mesh is None else mesh.device


def rank_rows(mesh, *arrays, device="cpu"):
    """This rank's rows of global numpy arrays, as tensors on its device
    (all of them, on ``device``, without a mesh)."""
    if mesh is None:
        return tuple(torch.from_numpy(a).to(device) for a in arrays)
    return parallel.shard_batch(mesh, arrays)


def float_state(sd: dict) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def scalars(metrics: dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def diffsep_trainer(device):
    return build_diffsep_trainer(override(diffsep(), DIFFSEP_TINY),
                                 device=device, seed=0)


def waveform_batch(b: int, t_len: int, seed: int):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((b, 1, t_len)).astype(np.float32)
    tgt = (0.5 * rng.standard_normal((b, 2, t_len))).astype(np.float32)
    return mix, tgt


def leg_diffsep(mesh, b: int, eval_items: int = 5) -> dict:
    """One train step, the PC sampler (N=2) on the new parameters, and
    ``evaluate_dataset`` over ``eval_items`` synthetic items in batches
    of 2 (rounded up to the devices)."""
    from ditsep_tpu_torch.data import SyntheticMixDataset
    from ditsep_tpu_torch.eval import evaluate_dataset

    dev = _device(mesh)
    trainer = diffsep_trainer(dev)
    mix, tgt = waveform_batch(b, 2048, seed=0)
    batch = rank_rows(mesh, mix, tgt)
    state = trainer.init_state()
    g = torch.Generator(device=dev).manual_seed(0)
    state, m = trainer.train_step(state, batch, generator=g, mesh=mesh)
    out = {"metrics": scalars(m),
           "state": float_state(state.model.state_dict()),
           "ema": float_state(state.ema.state_dict())}
    assert math.isfinite(out["metrics"]["train/score_loss"])
    assert state.step == 1

    g = torch.Generator(device=dev).manual_seed(1)
    with parallel.sharded(mesh):
        est, _ = trainer.separate(batch[0], N=2, generator=g,
                                  model=state.ema)
    est = parallel.all_gather_rows(est.cpu().numpy(), mesh)
    assert est.shape == (b, 2, 2048) and np.isfinite(est).all()
    out["est"] = est

    def sep(x, lengths=None, generator=None):
        return trainer.separate(x, N=2, generator=generator,
                                model=state.ema)[0]

    ds = SyntheticMixDataset(n_items=eval_items, min_len_s=0.5,
                             max_len_s=0.5)
    res = evaluate_dataset(sep, ds, fs=8000, batch_size=2, nfe=4,
                           warmup=False, device=dev, mesh=mesh)
    assert res["summary"]["number"] == eval_items
    assert np.isfinite(res["summary"]["si_sdr"])
    out["eval"], out["chunks"] = res["results"], res["chunks"]
    return out


def latent_trainer(device):
    return build_latent_trainer(override(latent_diffsep_ouve(), LATENT_TINY),
                                device=device, seed=0)


def leg_latent(mesh, b: int) -> dict:
    """One ``train_step_latent`` on a (b, ., 512) waveform batch."""
    dev = _device(mesh)
    trainer = latent_trainer(dev)
    mix, tgt = waveform_batch(b, 512, seed=1)
    state = trainer.init_state()
    g = torch.Generator(device=dev).manual_seed(2)
    state, m = trainer.train_step_latent(state, rank_rows(mesh, mix, tgt),
                                         generator=g, mesh=mesh)
    out = {"metrics": scalars(m),
           "state": float_state(state.model.state_dict()),
           "ema": float_state(state.ema.state_dict())}
    assert math.isfinite(out["metrics"]["train/score_loss"])
    return out


def seeded_disc(in_channels: int, device, n_fft: int, hop: int):
    from ditsep_tpu_torch.models.discriminators import (
        MultiScaleSTFTDiscriminator,
    )
    disc = MultiScaleSTFTDiscriminator(filters=4, in_channels=in_channels,
                                       n_ffts=(n_fft,), hop_lengths=(hop,))
    disc.reset_parameters(torch.Generator().manual_seed(in_channels))
    return disc.to(device)


def leg_ldm(mesh, b: int) -> dict:
    """A gen step (warmed up: the GAN terms on) and a disc step of the
    decoder finetune on the tiny latent VAE."""
    from ditsep_tpu_torch.training.ldm import LDMLossWeights, LDMTrainer

    dev = _device(mesh)
    lt = latent_trainer(dev)
    rng = np.random.default_rng(3)
    reals = (0.3 * rng.standard_normal((b, 2, 512))).astype(np.float32)
    with torch.no_grad():
        _, lat = lt.encode(torch.from_numpy(reals[:, :1]).to(dev),
                           torch.from_numpy(reals).to(dev))
    ldm = LDMTrainer(
        latent_trainer=lt, disc=seeded_disc(2, dev, 64, 16), lr=1e-3,
        weights=LDMLossWeights(fft_sizes=(256, 128), hop_sizes=(64, 32),
                               perceptual_weighting=False, l1=1.0,
                               adversarial=0.1, feature_matching=1.0))
    state = ldm.init_state()
    lat_r, reals_r = rank_rows(mesh, lat.cpu().numpy(), reals)
    state, mg = ldm.gen_step(state, lat_r, reals_r, warmed_up=True,
                             mesh=mesh)
    assert "train/loss_adv" in mg
    state, md = ldm.disc_step(state, lat_r, reals_r, mesh=mesh)
    assert state.step == 2
    out = {"metrics": {**scalars(mg), **scalars(md)},
           "state": float_state(state.decoder.state_dict()),
           "ema": float_state(state.ema_decoder.state_dict()),
           "disc": float_state(state.disc.state_dict())}
    assert all(math.isfinite(v) for v in out["metrics"].values())
    return out


def leg_vaegan(mesh, b: int) -> dict:
    """A gen step (warmed up) and a disc step of the VAE-GAN on a tiny
    OobleckVAE."""
    from ditsep_tpu_torch.models.oobleck import OobleckVAE
    from ditsep_tpu_torch.training.autoencoder import (
        AutoencoderLossConfig, AutoencoderTrainer,
    )

    dev = _device(mesh)
    vae = OobleckVAE(channels=8, c_mults=(1, 2), strides=(2, 4),
                     latent_dim=4)
    vae.reset_parameters(torch.Generator().manual_seed(4))
    tr = AutoencoderTrainer(
        vae=vae.to(dev), disc=seeded_disc(1, dev, 128, 32), lr=1e-3,
        loss_cfg=AutoencoderLossConfig(fft_sizes=(256, 128),
                                       hop_sizes=(64, 32),
                                       perceptual_weighting=False))
    rng = np.random.default_rng(5)
    reals = (0.3 * rng.standard_normal((b, 1, 1024))).astype(np.float32)
    (reals_r,) = rank_rows(mesh, reals)
    state = tr.init_state()
    g = torch.Generator(device=dev).manual_seed(6)
    state, mg = tr.gen_step(state, reals_r, warmed_up=True, generator=g,
                            mesh=mesh)
    state, md = tr.disc_step(state, reals_r, generator=g, mesh=mesh)
    assert state.step == 2
    out = {"metrics": {**scalars(mg), **scalars(md)},
           "state": float_state(state.vae.state_dict()),
           "ema": float_state(state.ema_vae.state_dict()),
           "disc": float_state(state.disc.state_dict())}
    assert all(math.isfinite(v) for v in out["metrics"].values())
    return out


def run_legs(mesh, b: Optional[int] = None) -> dict:
    """The four legs on ``mesh`` with a global batch of ``b`` (2 items a
    rank by default); rank 0 prints each. Returns their results."""
    n = 1 if mesh is None else mesh.devices.size
    b = ROWS * n if b is None else b
    say = (print if mesh is None or mesh.rank == 0
           else (lambda *a, **k: None))
    res = {"diffsep": leg_diffsep(mesh, b)}
    d = res["diffsep"]
    say(f"dryrun_multichip({n}): diffsep train loss="
        f"{d['metrics']['train/score_loss']:.4f}, sampler "
        f"{tuple(d['est'].shape)}, evaluate_dataset {len(d['eval'])} items "
        f"in chunks {[c[1] for c in d['chunks']]} ok", flush=True)
    res["latent"] = leg_latent(mesh, b)
    say(f"dryrun_multichip({n}): latent train loss="
        f"{res['latent']['metrics']['train/score_loss']:.4f} ok", flush=True)
    res["ldm"] = leg_ldm(mesh, b)
    m = res["ldm"]["metrics"]
    say(f"dryrun_multichip({n}): ldm gen/disc losses={m['train/loss']:.4f}"
        f"/{m['train/discriminator_loss']:.4f} ok", flush=True)
    res["vaegan"] = leg_vaegan(mesh, b)
    m = res["vaegan"]["metrics"]
    say(f"dryrun_multichip({n}): vae-gan gen/disc losses="
        f"{m['train/loss']:.4f}/{m['train/discriminator_loss']:.4f} ok",
        flush=True)
    say(f"dryrun_multichip({n}): all legs ok (diffsep train+sampler+"
        "evaluate_dataset, latent, ldm-gan, vae-gan)", flush=True)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="default: nccl on cards, gloo with --cpu")
    p.add_argument("--cpu", action="store_true",
                   help="ranks on the CPU (the default: one card a rank)")
    p.add_argument("--timeout-s", type=float, default=600.0)
    args = p.parse_args(argv)
    if args.cpu and args.backend == "nccl":
        raise SystemExit("nccl needs cards: drop --cpu or take gloo")
    parallel.launch(run_legs, args.nproc,
                    device="cpu" if args.cpu else "cuda",
                    backend=args.backend, timeout_s=args.timeout_s)


if __name__ == "__main__":
    main()
