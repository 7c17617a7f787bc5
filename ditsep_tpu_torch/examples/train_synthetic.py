"""End-to-end learning check (port of examples/train_synthetic.py): a small
DiffSep trained from scratch on synthetic mixtures, its separation SI-SDR
against the mixture's. Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.examples.train_synthetic --steps 5000 \\
        --nf 32 --batch 8 --len-s 4 --n-train 2048 --lr 5e-4 --eval-N 30 \\
        --eval-every 1000 --save-params ema.npz [--resume run.pt] \\
        [--seed 0] [--cpu]

The model is the diffsep config at width ``--nf`` with ch_mult (1,1,2,2)
and attention at 32, its weights seeded by ``--seed``. The training items
are ``SyntheticMixDataset`` (seed 0) of ``--len-s`` seconds, shuffled at
the start of each epoch by ``np.random.default_rng(i)`` (i the steps
taken) and padded by ``max_collator``: the JAX script's batches in its
order. The train step draws from a generator seeded by ``--seed``; float32
with cuDNN's default TF32 convolutions, as ``cli.train_diffsep`` trains on
the card. Every ``--eval-every`` steps and at the end, the trained
parameters and the EMA each separate the 8 test items (seed 10,000; PC at
N=``--eval-N``, a generator seeded 1) and are scored by the
permutation-invariant SI-SDR (zero mean, clamped at 30 dB); an interim
prints a JSON line and writes the EMA to ``--save-params`` (the JAX
package's flat .npz), as the end does. With ``--resume FILE`` an interim
also writes the training state there (the parameters, the EMA, the
optimizer, the step and the generator's state), and a run that finds the
file continues from it: the same batches and draws as a run that never
stopped. The last JSON line holds the JAX
script's keys and ``steps_per_s`` (training alone, evaluations left out),
``data_s`` (the host's seconds building batches), ``eval_s``, ``peak_gib``
and ``card`` (nvidia-smi's name and power limit).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ditsep_tpu_torch.configs import (
    CONFIG_FAMILIES, build_diffsep_trainer, override,
)
from ditsep_tpu_torch.data import SyntheticMixDataset, max_collator
from ditsep_tpu_torch.models.weights import save_params_npz
from ditsep_tpu_torch.training.losses import si_sdr_pit
from ditsep_tpu_torch.utils.device import card_line, resolve_device

TRAIN_SEED, TEST_SEED, EVAL_SEED = 0, 10_000, 1
TEST_ITEMS = 8


def synthetic_config(nf: int, more: Optional[dict] = None) -> dict:
    """The diffsep config of both example scripts at width ``nf``, with
    the ``more`` overrides."""
    return override(CONFIG_FAMILIES["diffsep"](), {
        "model.score_model.nf": nf,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,),
        **(more or {})})


def test_batch(n_items: int, len_s: float, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held-out items (seed 10,000) as one (mix, targets) batch."""
    ds = SyntheticMixDataset(n_items=n_items, min_len_s=len_s,
                             max_len_s=len_s, seed=TEST_SEED)
    mix, tgt = max_collator([ds[j] for j in range(len(ds))])
    return torch.from_numpy(mix).to(device), torch.from_numpy(tgt).to(device)


def mean_si_sdr(est: torch.Tensor, tgt: torch.Tensor) -> float:
    return float(si_sdr_pit(est, tgt, zero_mean=True, clamp_db=30.0).mean())


def recipe_batches(dataset, batch: int, steps: int, start: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batches ``start`` to ``steps`` (collated) in the JAX script's order:
    one index array shuffled in place by ``default_rng(i)`` at each
    epoch's start (i the batches taken so far), cut into full batches."""
    if len(dataset) < batch:
        raise ValueError(f"{len(dataset)} items cannot fill a batch of "
                         f"{batch}")
    order = np.arange(len(dataset))
    i = 0
    while i < steps:
        np.random.default_rng(i).shuffle(order)
        for s in range(0, len(order) - batch + 1, batch):
            if i >= start:
                yield max_collator([dataset[int(j)]
                                    for j in order[s:s + batch]])
            i += 1
            if i >= steps:
                return


def main(argv=None) -> Dict:
    """Train, evaluate and print; returns ``result`` (the last line),
    ``interims`` (their lines), ``losses`` (every step this run took) and
    the final TrainState (``state``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--nf", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--len-s", type=float, default=4.0)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--eval-N", type=int, default=30)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--save-params", default=None,
                   help="npz path for the trained (EMA) params")
    p.add_argument("--mask-padding", action="store_true",
                   help="train with the padding-robust masked "
                        "normalization")
    p.add_argument("--eval-every", type=int, default=0,
                   help="if >0, evaluate every N steps, print an interim "
                        "JSON line and write --save-params")
    p.add_argument("--resume", default=None, metavar="FILE",
                   help="write the training state here at each "
                        "--eval-every; continue from it if it exists")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights and the train step's draws")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = synthetic_config(args.nf, {
        "model.score_model.mask_padding": args.mask_padding,
        "model.lr": args.lr})
    trainer = build_diffsep_trainer(cfg, device=device, seed=args.seed)
    train_ds = SyntheticMixDataset(n_items=args.n_train,
                                   min_len_s=args.len_s,
                                   max_len_s=args.len_s, seed=TRAIN_SEED)
    card = card_line() if cuda else "cpu"
    n_params = sum(t.numel() for t in trainer.model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M, device: {card}",
          flush=True)
    state = trainer.init_state()

    mix_t, tgt_t = test_batch(TEST_ITEMS, args.len_s, device)
    si_mix = mean_si_sdr(mix_t.expand_as(tgt_t), tgt_t)

    def run_eval(st) -> Dict[str, float]:
        return {name: mean_si_sdr(trainer.separate(
            mix_t, N=args.eval_N, model=model,
            generator=torch.Generator(device).manual_seed(EVAL_SEED))[0],
            tgt_t) for name, model in (("params", st.model),
                                       ("ema", st.ema))}

    def to_device(a: np.ndarray) -> torch.Tensor:
        # on the card, from pinned memory without a wait, so that the host
        # builds the next batch while the card runs this step
        t = torch.from_numpy(a)
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    def snapshot(st):
        if args.save_params:
            save_params_npz(args.save_params, st.ema)

    gen = torch.Generator(device).manual_seed(args.seed)
    if args.resume and os.path.exists(args.resume):
        saved = torch.load(args.resume, map_location="cpu")
        state.load_state_dict(saved["train"])
        gen.set_state(saved["generator"])
        print(f"resumed at step {state.step} from {args.resume}",
              flush=True)
    start = state.step
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, printed, interims = [], [], []
    data_s = eval_s = 0.0
    batches = recipe_batches(train_ds, args.batch, args.steps, start)
    sync()
    t0 = time.perf_counter()
    for i in range(start + 1, args.steps + 1):
        t = time.perf_counter()
        mix_b, tgt_b = next(batches)
        data_s += time.perf_counter() - t
        state, m = trainer.train_step(
            state, (to_device(mix_b), to_device(tgt_b)), generator=gen)
        losses.append(m["train/score_loss"])
        if i % 100 == 0:
            printed.append(float(losses[-1]))
            rate = (i - start) / (time.perf_counter() - t0 - eval_s)
            print(f"step {i}: loss {printed[-1]:.4f} ({rate:.2f} steps/s)",
                  flush=True)
        if args.eval_every and i % args.eval_every == 0 and i < args.steps:
            sync()
            t = time.perf_counter()
            si_i = run_eval(state)
            snapshot(state)
            if args.resume:
                tmp = f"{args.resume}.tmp-{os.getpid()}"
                torch.save({"train": state.state_dict(),
                            "generator": gen.get_state()}, tmp)
                os.replace(tmp, args.resume)
            eval_s += time.perf_counter() - t
            interims.append({
                "interim_step": i,
                "si_sdr_separated": round(si_i["params"], 3),
                "si_sdr_separated_ema": round(si_i["ema"], 3),
                "si_sdr_mixture_baseline": round(si_mix, 3),
                "improvement_db": round(si_i["params"] - si_mix, 3)})
            print(json.dumps(interims[-1]), flush=True)
    sync()
    train_s = time.perf_counter() - t0 - eval_s

    t = time.perf_counter()
    si = run_eval(state)
    eval_s += time.perf_counter() - t
    result = {
        "steps": args.steps,
        "final_loss": printed[-1] if printed else None,
        "si_sdr_mixture_baseline": round(si_mix, 3),
        "si_sdr_separated": round(si["params"], 3),
        "si_sdr_separated_ema": round(si["ema"], 3),
        "improvement_db": round(si["params"] - si_mix, 3),
        "steps_per_s": (args.steps - start) / train_s,
        "data_s": data_s,
        "eval_s": eval_s,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if cuda else None),
        "card": card,
    }
    print(json.dumps(result), flush=True)
    if args.save_params:
        snapshot(state)
        print(f"saved EMA params to {args.save_params}", flush=True)
    return {"result": result, "interims": interims,
            "losses": torch.stack(losses).tolist() if losses else [],
            "state": state}


if __name__ == "__main__":
    main()
