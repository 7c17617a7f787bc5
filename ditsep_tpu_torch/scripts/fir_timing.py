"""Times of ``fir_down2d`` at every shape of the main path, on one CUDA card.

    python -m ditsep_tpu_torch.scripts.fir_timing [--iters 30] [--force]
        [--backward] [--latent]

The flagship U-Net (``diffsep_icassp``: nf=128, ch_mult (1,1,2,2,2,2,2))
downsamples by FIR at six levels: twice in each down block, on
(B, C_i, H_i, W_i) with C = 128, 128, 256, 256, 256, 256, and once on the
input pyramid, (B, 6, H_i, W_i), with H_i x W_i = 256 x 576 >> i at the
8.415 s flagship length: 18 launches a forward.

For each of those 12 shapes at batch 1 and 4, in f32 and bf16, NCHW (the
main path's layout), and at level 0 also channels_last, it prints one JSON
line: the device time of one call (``kernel_ms``, ``plain_ms``,
``library_ms``: calls captured in a CUDA graph and replayed between CUDA
events, over the calls), the time a caller sees (``call_ms``,
``library_call_ms``: ``utils/timing.py``'s CUDA events around
back-to-back calls on one input, host overhead included where the host is
slower than the card), and the byte bound (input read once, output written
once, over the card's memory rate). The library call is one ``F.conv2d``
depthwise 4x4 stride-2 conv, checked against the kernel and never used by
the port.

On the main path the layer before writes each input once, so the graph
cycles through copies of the input and gives every call its own output
until they span twice the card's L2 (``L2_SPAN``), in at most
``MAX_CALLS`` calls: a DRAM-bound time, not an L2 one. ``in_l2`` marks the
rows too small to span it that way. Then, per batch and dtype, one line of
sums over the 18 launches of a forward (2 x down block + pyramid at each
level).

``--force`` also times the scalar path where the vector one applies.

``--latent`` times the latent U-Net's shapes instead (``LatentScoreModel
NCSNpp`` of latent_diffsep_ouve: nf 128, ch_mult (1, 2, 2), the VAE's 64
latent channels as the height): at each of its two level transitions the
down block's two launches on (B, C, 64 >> i, Tl >> i), C = 128, 256, and
the input pyramid's on (B, 3, ...): 6 launches a forward, at (batch, Tl)
= (1, 36), (4, 36) (an 8.415 s separation: 33 latent frames padded to
36) and (1, 20), (16, 20) (a 5 s train crop), f32 and bf16, NCHW, each
row with the plan's path (fir_down2d's vector path needs W a multiple of
8 / 16, so none takes it); then the sums over a forward's 6 launches.
With ``--backward``, ``fir_up2d`` at the down-block shapes (its vector
path needs W a multiple of 4 / 8: level 0 in f32) and the sums over the 4
launches of a forward's backward.

``--backward`` times ``fir_up2d``, the downsample's backward, instead: at
the 12 down-block shapes of the flagship train step, (6, C, 256 x 384 >>
i) as the forward's input (g a quarter of it), in f32 and bf16, NCHW,
with the plain version, the library call (one ``F.conv_transpose2d``
depthwise 4x4 stride-2 conv, cuDNN in full float32) and the byte bound (g read once, dx written
once); then the sum over a train step's 24 launches (two forwards).

To time two checkouts on one card, copy this file and ``utils/timing.py``
into the other one and run it from each. Prints JSON lines, writes no
file.
"""
from __future__ import annotations

import argparse
import json

DOWN_CHANNELS = (128, 128, 256, 256, 256, 256)
PYRAMID_CHANNELS = 6
LEVEL0_HW = (256, 576)
FIR_K = (1.0, 3.0, 3.0, 1.0)
L2_SPAN = 2       # the bytes a timing graph cycles through, in L2 sizes
MAX_CALLS = 256   # calls of one timing graph, at most
TRAIN_BATCH = 6   # the flagship's train batch
TRAIN_HW = (256, 384)  # 40,960 samples: 323 frames padded to 384
LATENT_D = 64     # the latent U-Net's height: the VAE's latent channels
LATENT_DOWN_CHANNELS = (128, 256)  # nf 128, ch_mult (1, 2, 2)
LATENT_PYRAMID_CHANNELS = 3        # the sources and the mixture
# (batch, latent frames): an 8.415 s separation at batch 1 and 4, a 5 s
# train crop at batch 1 and the config's 16
LATENT_CASES = ((1, 36), (4, 36), (1, 20), (16, 20))


def main_path_shapes(batch: int) -> list:
    """(kind, level, NCHW shape) of the main path's fir_down2d inputs."""
    out = []
    for i, c in enumerate(DOWN_CHANNELS):
        h, w = LEVEL0_HW[0] >> i, LEVEL0_HW[1] >> i
        out += [("down", i, (batch, c, h, w)),
                ("pyramid", i, (batch, PYRAMID_CHANNELS, h, w))]
    return out


def graph_ms(fns, iters: int = 30, warmup: int = 3, reps: int = 3) -> float:
    """Device time of one call: ``iters`` calls, the i-th of ``fns[i %
    len(fns)]``, captured in one CUDA graph and replayed ``reps`` times
    between CUDA events, so no host time is in it; what is left besides
    the kernels is the graph's gap between two kernel nodes. The calls'
    outputs live until the capture ends, so each call writes its own."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fns[i % len(fns)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fns[i % len(fns)]() for i in range(iters)]
    del outs  # back to the graph's own pool: the replays still write them
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _copies(nbytes: int, iters: int):
    """(input copies, calls, span) of a timing graph whose calls, of
    ``nbytes`` each, cycle through ``span`` = twice the L2."""
    import torch
    span = L2_SPAN * torch.cuda.get_device_properties(0).L2_cache_size
    copies = min(MAX_CALLS, -(-span // nbytes))
    return copies, max(iters, copies), span


def time_shape(shape, dtype, channels_last: bool, bandwidth: float,
               iters: int = 30, force: bool = False, seed: int = 0) -> dict:
    """One timed row: kernel, plain version, library call, byte bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.utils.timing import call_ms

    g = torch.Generator(device="cuda").manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    x = x.contiguous(memory_format=fmt)
    taps_h, taps_w = ck.separable_taps(np.asarray(FIR_K), 1.0)
    c = shape[1]
    wk = torch.outer(torch.tensor(taps_h), torch.tensor(taps_w))
    wk = wk.to(device="cuda", dtype=dtype).expand(c, 1, 4, 4)
    y = ck.fir_down2d(x, taps_h, taps_w)
    # the library call computes the same function (checked, not used)
    lerr = (F.conv2d(x, wk, stride=2, padding=1, groups=c).float()
            - y.float()).abs().max().item()
    peak = y.float().abs().max().item()
    ltol = 1e-5 * peak if dtype == torch.float32 else 2 * ck.bf16_ulp(peak)
    if lerr > ltol:
        raise RuntimeError(f"library call disagrees with fir_down2d at "
                           f"{shape} {dtype}: {lerr} > {ltol}")
    esize = x.element_size()
    nbytes = (x.numel() + y.numel()) * esize
    copies, calls, span = _copies(nbytes, iters)
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    cycled = copies * x.numel() * esize + calls * y.numel() * esize
    kern = [lambda xi=xi: ck.fir_down2d(xi, taps_h, taps_w) for xi in xs]
    lib = [lambda xi=xi: F.conv2d(xi, wk, stride=2, padding=1, groups=c)
           for xi in xs]
    plain = [lambda xi=xi: ck.downsample_2d_plain(xi, FIR_K) for xi in xs]
    row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "layout": "channels_last" if channels_last else "nchw",
           "path": ck.fir_down2d.plan(x)["path"],
           "kernel_ms": graph_ms(kern, calls),
           "plain_ms": graph_ms(plain, calls),
           "library_ms": graph_ms(lib, calls),
           "call_ms": call_ms(kern[0], iters),
           "library_call_ms": call_ms(lib[0], iters),
           "bound_ms": nbytes / bandwidth * 1e3,
           "graph_calls": calls, "input_copies": copies,
           "in_l2": cycled < span}
    if force:
        plan = ck.fir_down2d.plan(x)
        row["plan"] = plan
        if plan["path"] == "vector":
            row["scalar_ms"] = graph_ms(
                [lambda xi=xi: ck.fir_down2d(xi, taps_h, taps_w,
                                             force_path="scalar")
                 for xi in xs], calls)
    return row


def train_path_shapes(batch: int = TRAIN_BATCH) -> list:
    """(level, NCHW shape) of the forward inputs whose gradients fir_up2d
    computes in a train step: the down blocks' (h and the skip x; the
    input pyramid acts on data and needs none)."""
    return [(i, (batch, c, TRAIN_HW[0] >> i, TRAIN_HW[1] >> i))
            for i, c in enumerate(DOWN_CHANNELS)]


def time_up_shape(shape, dtype, channels_last: bool, bandwidth: float,
                  iters: int = 30, seed: int = 0) -> dict:
    """One timed row of fir_up2d for a forward input of ``shape``: kernel,
    plain version, library call (checked against the kernel), byte
    bound. cuDNN runs in full float32 meanwhile (TF32 off), so that the
    library call computes the same function as the kernel."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _time_up_shape(shape, dtype, channels_last, bandwidth, iters,
                              seed)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _time_up_shape(shape, dtype, channels_last, bandwidth, iters, seed):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.utils.timing import call_ms

    n, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gy = torch.randn((n, c, h // 2, w // 2), generator=g, device="cuda")
    gy = gy.to(dtype).contiguous(memory_format=fmt)
    taps_h, taps_w = ck.separable_taps(np.asarray(FIR_K), 1.0)
    wk = torch.outer(torch.tensor(taps_h), torch.tensor(taps_w))
    wk = wk.to(device="cuda", dtype=dtype).expand(c, 1, 4, 4)
    pad = (h % 2, w % 2)
    dx = ck.fir_up2d(gy, taps_h, taps_w, (h, w))
    lib = lambda gi: F.conv_transpose2d(gi, wk, stride=2, padding=1,
                                        output_padding=pad, groups=c)
    lerr = (lib(gy).float() - dx.float()).abs().max().item()
    peak = dx.float().abs().max().item()
    ltol = 1e-5 * peak if dtype == torch.float32 else 2 * ck.bf16_ulp(peak)
    if lerr > ltol:
        raise RuntimeError(f"library call disagrees with fir_up2d at "
                           f"{shape} {dtype}: {lerr} > {ltol}")
    esize = gy.element_size()
    nbytes = (gy.numel() + dx.numel()) * esize
    copies, calls, span = _copies(nbytes, iters)
    gs = [gy] + [gy.clone() for _ in range(copies - 1)]
    cycled = copies * gy.numel() * esize + calls * dx.numel() * esize
    kern = [lambda gi=gi: ck.fir_up2d(gi, taps_h, taps_w, (h, w))
            for gi in gs]
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "layout": "channels_last" if channels_last else "nchw",
            "path": ck.fir_up2d.plan(gy, (h, w))["path"],
            "kernel_ms": graph_ms(kern, calls),
            "plain_ms": graph_ms([lambda gi=gi: ck.downsample_2d_bwd_plain(
                gi, FIR_K, (h, w)) for gi in gs], calls),
            "library_ms": graph_ms([lambda gi=gi: lib(gi) for gi in gs],
                                   calls),
            "call_ms": call_ms(kern[0], iters),
            "bound_ms": nbytes / bandwidth * 1e3,
            "graph_calls": calls, "input_copies": copies,
            "in_l2": cycled < span}


def time_train_path(bandwidth: float, iters: int = 30) -> list:
    """fir_up2d rows at the train path's 6 shapes, f32 and bf16, NCHW,
    then per dtype the sums over a train step's 24 launches."""
    import torch
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for _, shape in train_path_shapes():
            rows.append(time_up_shape(shape, dtype, False, bandwidth, iters))
        torch.cuda.empty_cache()
    sums = []
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        # 2 launches a down block (h and x) in each of the step's 2
        # forwards
        tot = {k: 4 * sum(r[k] for r in mine)
               for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        sums.append({"per_train_step": True, "dtype": dtype,
                     "launches": 4 * len(mine), **tot,
                     "kernel_over_bound": tot["kernel_ms"] / tot["bound_ms"]})
    return rows + sums


def forward_sums(rows: list) -> list:
    """Per batch and dtype, NCHW: the 18 launches of one forward (2 per
    down block, 1 per pyramid level) summed, kernel against bound and
    library."""
    out = []
    keys = sorted({(r["shape"][0], r["dtype"]) for r in rows
                   if r["layout"] == "nchw"})
    for batch, dtype in keys:
        mine = [r for r in rows if r["layout"] == "nchw"
                and r["shape"][0] == batch and r["dtype"] == dtype]
        if len(mine) != 12:
            continue
        weight = lambda r: 1 if r["shape"][1] == PYRAMID_CHANNELS else 2
        sums = {k: sum(weight(r) * r[k] for r in mine)
                for k in ("kernel_ms", "library_ms", "bound_ms", "call_ms",
                          "library_call_ms")}
        out.append({"per_forward": True, "batch": batch, "dtype": dtype,
                    "launches": sum(weight(r) for r in mine),
                    "in_l2_launches": sum(weight(r) for r in mine
                                          if r["in_l2"]), **sums,
                    "kernel_over_bound": sums["kernel_ms"] / sums["bound_ms"]})
    return out


def time_main_path(bandwidth: float, batches=(1, 4), iters: int = 30,
                   force: bool = False) -> list:
    """Timed rows at every main-path shape (NCHW) of ``batches`` in f32 and
    bf16, channels_last at level 0, then the per-forward sums."""
    import torch
    out = []
    for batch in batches:
        for dtype in (torch.float32, torch.bfloat16):
            for _, level, shape in main_path_shapes(batch):
                layouts = ((False, True) if level == 0
                           and shape[1] != PYRAMID_CHANNELS else (False,))
                for cl in layouts:
                    out.append(time_shape(shape, dtype, cl, bandwidth, iters,
                                          force))
            torch.cuda.empty_cache()
    return out + forward_sums(out)


def latent_path_shapes(batch: int, tl: int) -> list:
    """(kind, level, NCHW shape) of the latent U-Net's fir_down2d inputs
    at ``tl`` latent frames."""
    out = []
    for i, c in enumerate(LATENT_DOWN_CHANNELS):
        h, w = LATENT_D >> i, tl >> i
        out += [("down", i, (batch, c, h, w)),
                ("pyramid", i, (batch, LATENT_PYRAMID_CHANNELS, h, w))]
    return out


def time_latent_path(bandwidth: float, backward: bool = False,
                     iters: int = 30) -> list:
    """Rows at the latent U-Net's shapes of every LATENT_CASES entry, f32
    and bf16, NCHW (``backward``: fir_up2d at the down-block shapes), then
    per case and dtype the sums over a forward's 6 launches (2 a down
    block, 1 a pyramid level) or a forward's backward's 4 (2 a down
    block)."""
    import torch
    rows, sums = [], []
    for batch, tl in LATENT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            mine = []
            for kind, _, shape in latent_path_shapes(batch, tl):
                if backward and kind == "pyramid":
                    continue
                row = (time_up_shape(shape, dtype, False, bandwidth, iters)
                       if backward else
                       time_shape(shape, dtype, False, bandwidth, iters))
                row["weight"] = 2 if kind == "down" else 1
                mine.append(row)
            rows += mine
            tot = {k: sum(r["weight"] * r[k] for r in mine)
                   for k in ("kernel_ms", "plain_ms", "library_ms",
                             "bound_ms")}
            sums.append({"per_forward" if not backward
                         else "per_backward": True, "batch": batch,
                         "latent_frames": tl,
                         "dtype": str(dtype).split(".")[-1],
                         "launches": sum(r["weight"] for r in mine), **tot,
                         "kernel_over_bound": tot["kernel_ms"]
                         / tot["bound_ms"],
                         "kernel_over_library": tot["kernel_ms"]
                         / tot["library_ms"]})
            torch.cuda.empty_cache()
    return rows + sums


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--force", action="store_true",
                    help="also time the scalar path where the vector one "
                         "applies")
    ap.add_argument("--backward", action="store_true",
                    help="time fir_up2d at the train step's shapes")
    ap.add_argument("--latent", action="store_true",
                    help="time the latent U-Net's shapes")
    args = ap.parse_args(argv)
    import torch
    from ditsep_tpu_torch.utils.device import card_line, card_peaks
    if not torch.cuda.is_available():
        raise RuntimeError("fir_timing needs a CUDA card")
    card = card_line()
    if args.latent:
        rows = time_latent_path(card_peaks(card)[1], args.backward,
                                args.iters)
    elif args.backward:
        rows = time_train_path(card_peaks(card)[1], args.iters)
    else:
        rows = time_main_path(card_peaks(card)[1], tuple(args.batches),
                              args.iters, args.force)
    for r in rows:
        print(json.dumps({**r, "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
