"""Bucketed batched test-set evaluation (port of
ditsep_tpu/eval/evaluate.py).

Utterances are bucketed by length into fixed-shape batches, each batch
rides one ``separate_fn`` call on the model's device, and the metrics run
on host threads while the card samples the next batch. Over a mesh each
rank separates its rows of every batch and rank 0 scores them.

Output schema matches the reference artifacts exactly
(results/<...>/librimix_test.json and _summary.json), key for key and in
the same order, so results diff directly against the JAX package's.
"""
from __future__ import annotations

import bisect
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ditsep_tpu_torch import viz
from ditsep_tpu_torch.data.wsj0_mix import max_collator
from ditsep_tpu_torch.eval.metrics import compute_metrics
from ditsep_tpu_torch.ops.stft import n_frames_prepadded
from ditsep_tpu_torch.parallel import (
    all_gather_rows, broadcast_object, check_one_device_a_rank, shard_batch,
    sharded,
)
from ditsep_tpu_torch.utils.device import resolve_device

METRIC_WORKERS = 4  # host threads scoring one batch while the next samples


def _bucket_lengths_frames(lengths, frame_spec, max_buckets: int):
    """Frame-block-aware bucketing: group utterances so that padding never
    pushes one across a 64-frame STFT block boundary.

    The score model zero-pads its STFT frames to a multiple of 64, so an
    utterance already carries ``64*ceil(frames/64) - frames`` quiet
    columns through the U-Net's GroupNorms; padding it past its own block
    jumps that quiet fraction far outside the training condition and
    quality falls off a cliff (docs/pad_dilution_r03.md). Bucketing by
    frame block keeps each utterance's quiet fraction that of its native,
    batch-1 evaluation.

    Returns ({index: padded_length}, merged_indices). Distinct padded
    lengths are capped at ``max_buckets`` by merging the smallest-count
    blocks upward (the largest block never merges); ``merged_indices``
    lists the utterances padded past their native frame block."""
    n_fft, hop, block = frame_spec
    blocks: Dict[int, list] = {}
    for i, length in enumerate(lengths):
        b = -(-n_frames_prepadded(length, n_fft, hop) // block)
        blocks.setdefault(b, []).append(i)
    native = {i: b for b, idxs in blocks.items() for i in idxs}
    merged: set = set()
    if len(blocks) > max_buckets:
        while len(blocks) > max_buckets:
            order = sorted(blocks)
            cand = min(order[:-1], key=lambda b: len(blocks[b]))
            nxt = order[order.index(cand) + 1]
            blocks[nxt] = blocks[nxt] + blocks.pop(cand)
        merged = {i for b, idxs in blocks.items()
                  for i in idxs if native[i] != b}
        print(f"[evaluate] merged {len(merged)} utterances into higher "
              f"frame blocks to respect max_buckets={max_buckets}; "
              f"their padded quiet fraction exceeds native eval "
              f"(raise --max-buckets for strict native parity)")
    out = {}
    for b, idxs in blocks.items():
        pad_len = max(lengths[i] for i in idxs)
        for i in idxs:
            out[i] = pad_len
    return out, merged


def _bucket_lengths(lengths, bucket_multiple: int, max_buckets: int):
    """Map each utterance length to a padded length, a multiple of
    ``bucket_multiple``, capping the distinct padded shapes at
    ``max_buckets``: past the cap, boundaries fall on per-utterance-count
    quantiles. Returns ({index: padded_length}, merged_indices), the
    merged ones padded past their own rounded length."""
    own = {i: -(-length // bucket_multiple) * bucket_multiple
           for i, length in enumerate(lengths)}
    rounded = sorted(set(own.values()))
    if len(rounded) > max_buckets:
        by_len = sorted(lengths)
        n = len(by_len)
        bounds = sorted({
            -(-by_len[min(n - 1, (k * n) // max_buckets - 1)]
              // bucket_multiple) * bucket_multiple
            for k in range(1, max_buckets + 1)})
        if bounds[-1] < rounded[-1]:
            bounds[-1] = rounded[-1]
        print(f"[evaluate] consolidating {len(rounded)} length buckets "
              f"-> {len(bounds)} (max_buckets={max_buckets}); padded "
              f"shapes: {bounds}")
        rounded = bounds
    out = {i: rounded[bisect.bisect_left(rounded, length)]
           for i, length in enumerate(lengths)}
    merged = {i for i in out if out[i] > own[i]}
    return out, merged


def _host_fence(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_numpy(est) -> np.ndarray:
    if isinstance(est, torch.Tensor):
        return est.detach().float().cpu().numpy()
    return np.asarray(est)


def evaluate_dataset(
    separate_fn,
    dataset,
    *,
    fs: int = 8000,
    batch_size: int = 4,
    bucket_multiple: int = 4096,
    frame_spec: Optional[tuple] = None,
    max_buckets: int = 8,
    nfe: int = 60,
    out_dir: Optional[str] = None,
    split_name: str = "test",
    limit: Optional[int] = None,
    seed: int = 0,
    save_samples: int = 0,
    save_figures: int = 0,
    warmup: bool = True,
    pass_lengths: bool = False,
    device="cuda",
    mesh=None,
) -> Dict:
    """Evaluate ``separate_fn(mix, lengths=None, generator=g) -> est`` over
    a dataset of (mix, target) numpy items.

    ``mix`` is a (B, 1, T) float32 tensor on ``device`` and ``est`` a
    (B, n, T) tensor or array. ``g`` is the run's one ``torch.Generator``
    on ``device``, seeded with ``seed``; every timed call draws from it in
    turn, and a warmup call draws what its timed call then draws again.
    ``pass_lengths=True`` also passes ``lengths`` (B,) int64 on
    ``device``, each item's true sample count, for masked score models.

    ``frame_spec`` (n_fft, hop, block) buckets by the score model's
    64-frame STFT blocks (it must be the model's grid, or it re-creates
    the cliff it prevents); None buckets by ``bucket_multiple`` samples.
    Each bucket's batches are ``batch_size`` items, the last filled up
    with its last item; items are left-aligned, their padding trailing.

    ``runtime`` is the timed call's wall clock over its real items, to the
    card's synchronization after it; each bucket's first batch is run
    once untimed first (``warmup``), as the reference times steady state
    (src/evaluate_mp.py:313-327).

    Returns {"results": per-utterance dict, "summary": mean dict} and,
    beside them, "buckets" ({padded length: items}), "calls" (the
    separate_fn calls, warmups included), "chunks" ((padded length,
    real items, items) of each batch, in order), "metrics_s" (the metric
    threads' summed seconds, and the seconds the run waited for them
    after its last call) and "media_failures" (the figures that failed:
    printed and counted, the run going on); writes ``<split>.json`` and
    ``<split>_summary.json`` into ``out_dir`` when given, and into
    ``<out_dir>/<split>_media/`` the estimates of the first
    ``save_samples`` items as ``{idx:04d}.enh{s}.wav`` and, where
    matplotlib is installed, the spectrogram grid of the first
    ``save_figures`` as ``{idx:04d}.pdf``.

    With ``mesh`` (a process group's, ``parallel.make_mesh``) every batch
    is ``ceil(batch_size / n) * n`` items for n devices, filled up with
    its last item (ditsep_tpu/eval/evaluate.py:208-260); each rank
    separates its rows with the whole batch's draws (``parallel.
    sharded``), rank 0 gathers the estimates, scores the real items,
    writes the files, and sends every rank the results. ``runtime`` is
    the call and the gather over the batch's real items."""
    device = resolve_device(device)
    check_one_device_a_rank(mesh, "evaluation")
    n_items = len(dataset) if limit is None else min(limit, len(dataset))
    get_len = getattr(dataset, "item_length", None)
    lengths = ([get_len(i) for i in range(n_items)] if get_len
               else [dataset[i][0].shape[-1] for i in range(n_items)])
    if frame_spec is not None:
        assigned, merged_idx = _bucket_lengths_frames(lengths, frame_spec,
                                                      max_buckets)
    else:
        assigned, merged_idx = _bucket_lengths(lengths, bucket_multiple,
                                               max_buckets)
    buckets: Dict[int, list] = {}
    for i in range(n_items):
        buckets.setdefault(assigned[i], []).append(i)

    n_dev = 1 if mesh is None else mesh.devices.size
    # every batch splits evenly over the data axis: round the batch up to
    # a device-count multiple
    eff_batch = -(-batch_size // n_dev) * n_dev
    rank_zero = mesh is None or mesh.rank == 0
    results: Dict[str, Dict] = {}
    futures = {}
    generator = torch.Generator(device=device).manual_seed(seed)
    calls = 0
    chunks = []
    media_failures = 0
    if save_figures and not viz.available():
        print("evaluate_dataset: matplotlib is not installed, no figures "
              "are saved", file=sys.stderr)
        save_figures = 0

    def run(mix_t, kw):
        with sharded(mesh):
            est = separate_fn(mix_t, **kw)
        _host_fence(device)
        if mesh is not None:
            est = all_gather_rows(_to_numpy(est), mesh)
        return est

    with ThreadPoolExecutor(METRIC_WORKERS) as pool:
        for blen, idxs in sorted(buckets.items()):
            warmed = not warmup
            for start in range(0, len(idxs), eff_batch):
                chunk = idxs[start:start + eff_batch]
                items = [dataset[i] for i in chunk]
                n_real = len(items)
                while len(items) < eff_batch:
                    items.append(items[-1])
                chunks.append((blen, n_real, eff_batch))
                # left-aligned: the padding is trailing quiet, as the model's
                # own %64 frame pad
                mix_b, tgt_b = max_collator(items, pad_to=blen, align="left")
                lens = np.array([it[0].shape[-1] for it in items], np.int64)
                if mesh is None:
                    mix_t = torch.from_numpy(mix_b).to(device)
                    lens_t = torch.from_numpy(lens).to(device)
                else:
                    mix_t, lens_t = shard_batch(mesh, (mix_b, lens))
                kw = {"generator": generator}
                if pass_lengths:
                    kw["lengths"] = lens_t
                if not warmed:  # the timed call then draws the same noise
                    state = generator.get_state()
                    run(mix_t, kw)
                    generator.set_state(state)
                    calls += 1
                    warmed = True
                t0 = time.perf_counter()
                est = run(mix_t, kw)
                runtime = (time.perf_counter() - t0) / n_real
                calls += 1
                est = _to_numpy(est)
                if not rank_zero:
                    continue
                for bi in range(n_real):
                    i = chunk[bi]
                    sl = slice(0, lengths[i])  # left-aligned collation
                    futures[i] = pool.submit(
                        _timed_metrics_entry, i, mix_b[bi][:, sl],
                        est[bi][:, sl], tgt_b[bi][:, sl], fs, runtime, nfe,
                        i in merged_idx)
                    if out_dir is not None and (i < save_samples
                                                or i < save_figures):
                        media_failures += not _save_media(
                            out_dir, split_name, i, mix_b[bi][:, sl],
                            est[bi][:, sl], tgt_b[bi][:, sl], fs,
                            wavs=i < save_samples, figure=i < save_figures)

        t_wait = time.perf_counter()
        metric_s = 0.0
        for i, fut in futures.items():
            results[str(i)], sec = fut.result()
            metric_s += sec
        wait_s = time.perf_counter() - t_wait

    summary = _summarize(results)
    # a run whose padding crossed native frame blocks must be told apart
    # from a native-parity one in the artifact itself
    summary["merged_utterances"] = len(merged_idx)
    if merged_idx:
        summary["merged_indices"] = sorted(int(i) for i in merged_idx
                                           if i < n_items)
    results, summary = broadcast_object((results, summary), mesh)
    if out_dir is not None and rank_zero:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"{split_name}.json", "w") as f:
            json.dump(results, f, indent=0)
        with open(out / f"{split_name}_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
    return {"results": results, "summary": summary,
            "buckets": {b: len(v) for b, v in sorted(buckets.items())},
            "chunks": chunks, "calls": calls,
            "metrics_s": {"threads": metric_s, "wait_after_last_call":
                          wait_s}, "media_failures": media_failures}


def _save_media(out_dir, split_name, idx, mix, est, target, fs,
                wavs=True, figure=False) -> bool:
    """With ``wavs`` the estimates as ``<split>_media/{idx:04d}.enh{s}
    .wav``, peak normalized to 0.95 (the reference's enh{i}.wav names,
    src/evaluate_mp.py:100-168); with ``figure`` the spectrogram grid of
    the mixture, the estimates and the targets as ``{idx:04d}.pdf``. A
    figure must not stop the run: its failure is printed and the call
    returns False."""
    from ditsep_tpu_torch.data import write_wav

    media = Path(out_dir) / f"{split_name}_media"
    media.mkdir(parents=True, exist_ok=True)
    if wavs:
        peak = max(float(np.abs(est).max()), 1e-6)
        for s in range(est.shape[0]):
            write_wav(str(media / f"{idx:04d}.enh{s}.wav"),
                      est[s] * 0.95 / peak, fs)
    if figure:
        try:
            fig = viz.separation_figure(mix.reshape(-1), est, target, fs=fs)
            fig.savefig(str(media / f"{idx:04d}.pdf"))
            import matplotlib.pyplot as plt
            plt.close(fig)
        except Exception as e:
            print(f"evaluate_dataset: the figure of item {idx} failed: "
                  f"{e!r}\n{traceback.format_exc()}", file=sys.stderr)
            return False
    return True


def _timed_metrics_entry(*args):
    t0 = time.perf_counter()
    out = _metrics_entry(*args)
    return out, time.perf_counter() - t0


def _metrics_entry(idx, mix, est, target, fs, runtime, nfe,
                   merged_pad: bool = False) -> Dict:
    m = compute_metrics(est, target, fs=fs)
    out = {
        "batch_idx": idx,
        "si_sdr": [m["si_sdr"]],
        "si_sir": [m["si_sir"]],
        "si_sar": [m["si_sar"]],
        "pesq": m["pesq"],  # per-source lists (reference schema:
        "stoi": m["stoi"],  # evaluate_mp.py:183-187 loops over sources)
        "pesq_impl": m["pesq_impl"],
        "nfe": nfe,
        "runtime": runtime,
        "len_s": target.shape[-1] / fs,
    }
    if merged_pad:  # padded past its native frame block: not native-equal
        out["merged_pad"] = True
    return out


def _summarize(results: Dict[str, Dict]) -> Dict:
    """Mean over utterances, in the reference's key order
    (src/evaluate_mp.py:192-209), with the PESQ backend."""
    if not results:
        return {}
    keys = ["si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe", "runtime",
            "len_s", "batch_idx"]
    out = {}
    for k in keys:
        vals = [np.nanmean(np.asarray(r.get(k), dtype=np.float64))
                for r in results.values()]
        out[k] = float(np.nanmean(vals))
    out["number"] = len(results)
    ordered = {"batch_idx": out.pop("batch_idx")}
    ordered.update({k: out[k] for k in
                    ["si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe",
                     "runtime", "len_s", "number"]})
    impls = {r.get("pesq_impl") for r in results.values()} - {None}
    if impls:
        ordered["pesq_impl"] = (sorted(impls)[0] if len(impls) == 1
                                else sorted(impls))
    return ordered
