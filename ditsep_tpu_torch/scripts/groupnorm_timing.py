"""Times of the port's unmasked GroupNorm both ways, at the shapes of two
main paths, on one CUDA card.

    python -m ditsep_tpu_torch.scripts.groupnorm_timing [--iters 20]

``models/layers.py``'s ``GroupNorm`` takes an unmasked call's statistics
by plain reductions when its (item, group) rows are few and long
(``GN_PLAIN_MAX_ROWS``, ``GN_PLAIN_MIN_ROW``), and by ``F.group_norm``
(one thread block a row) otherwise. This script records every GroupNorm
call of one forward of

- the flagship score network (``diffsep_icassp``: nf 128, 8.415 s at
  8 kHz) at batch 1 and 4, in f32 and bf16, and
- DAU1d at the reference class's defaults (stereo, depth 14, 65,536
  samples, batch 1),

and prints one JSON line for each distinct (shape, groups, dtype): the
rows, the row length, the time of one call by ``F.group_norm``
(``library_ms``) and by the plain reductions (``plain_ms``), both by
``utils/timing.call_ms``, and how many calls of it a forward makes. Then,
for each model, one line of the forward's time with ``F.group_norm``
always, with the plain reductions always, and as the module chooses. Seeded weights; prints JSON lines, writes no file.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess

FLAGSHIP_SAMPLES = 67320  # 8.415 s at 8 kHz
DAU_SAMPLES = 65536
# (GN_PLAIN_MAX_ROWS, GN_PLAIN_MIN_ROW) of each way
LIBRARY, PLAIN = (0, 0), (1 << 62, -1)


@contextlib.contextmanager
def statistics_by(way):
    """``layers``' choice of the statistics set to ``way`` within (None:
    the module's own)."""
    from ditsep_tpu_torch.models import layers
    old = layers.GN_PLAIN_MAX_ROWS, layers.GN_PLAIN_MIN_ROW
    if way is not None:
        layers.GN_PLAIN_MAX_ROWS, layers.GN_PLAIN_MIN_ROW = way
    try:
        yield
    finally:
        layers.GN_PLAIN_MAX_ROWS, layers.GN_PLAIN_MIN_ROW = old


def recorded_calls(model, run) -> collections.Counter:
    """(shape, groups, input dtype, compute dtype) of each unmasked
    GroupNorm call of ``run()``, counted."""
    from ditsep_tpu_torch.models.layers import GroupNorm
    seen = collections.Counter()

    def hook(mod, args):
        if len(args) < 2 or args[1] is None:
            seen[(tuple(args[0].shape), mod.num_groups, args[0].dtype,
                  mod.compute_dtype)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, GroupNorm)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return seen


def time_calls(label: str, seen, iters: int) -> None:
    import math
    import torch
    from ditsep_tpu_torch.models.layers import GroupNorm
    from ditsep_tpu_torch.utils.timing import call_ms

    for (shape, groups, dtype, cdt), n in sorted(seen.items(), key=str):
        gn = GroupNorm(groups, shape[1], 1e-6, cdt).cuda()
        x = torch.randn(shape, device="cuda").to(dtype)
        row = {"model": label, "shape": list(shape), "groups": groups,
               "dtype": str(dtype).replace("torch.", ""),
               "rows": shape[0] * groups,
               "row_length": math.prod(shape[1:]) // groups,
               "calls_a_forward": n}
        with torch.no_grad():
            for name, way in (("library_ms", LIBRARY),
                              ("plain_ms", PLAIN)):
                with statistics_by(way):
                    row[name] = call_ms(lambda: gn(x), iters=iters)
        print(json.dumps(row), flush=True)


def time_forward(label: str, run, iters: int) -> None:
    import torch
    from ditsep_tpu_torch.models import layers
    from ditsep_tpu_torch.utils.timing import call_ms

    row = {"model": label, "gn_plain_max_rows": layers.GN_PLAIN_MAX_ROWS,
           "gn_plain_min_row": layers.GN_PLAIN_MIN_ROW}
    with torch.no_grad():
        for name, way in (("library_forward_ms", LIBRARY),
                          ("plain_forward_ms", PLAIN), ("forward_ms", None)):
            with statistics_by(way):
                row[name] = call_ms(run, iters=iters)
    print(json.dumps(row), flush=True)


def flagship(dtype: str, batch: int, iters: int) -> None:
    import torch
    from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep_icassp

    cfg = diffsep_icassp()
    cfg["model"]["score_model"]["dtype"] = dtype
    trainer = build_diffsep_trainer(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    mix = torch.randn(batch, 1, FLAGSHIP_SAMPLES, device="cuda", generator=g)
    xt = torch.randn(batch, 2, FLAGSHIP_SAMPLES, device="cuda", generator=g)
    t = torch.full((batch,), 0.5, device="cuda")

    def run():
        return trainer.model_fwd(xt, t, mix)

    label = f"flagship_{dtype}_b{batch}"
    with torch.no_grad():
        seen = recorded_calls(trainer.model, run)
    time_calls(label, seen, iters)
    time_forward(label, run, iters)


def dau1d(iters: int) -> None:
    import torch
    from ditsep_tpu_torch.models.factory import create_model_from_config

    cfg = {"model_type": "diffusion_uncond",
           "model": {"type": "DAU1d", "config": {}}}
    with torch.device("cuda"):
        dau = create_model_from_config(
            cfg, torch.Generator(device="cuda").manual_seed(40)).eval()
    x = torch.randn(1, dau.io_channels, DAU_SAMPLES, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(41))
    t = torch.full((1,), 0.5, device="cuda")

    def run():
        return dau(x, t)

    with torch.no_grad():
        seen = recorded_calls(dau, run)
    time_calls("dau1d", seen, iters)
    time_forward("dau1d", run, iters)


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_timing needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for dtype in ("f32", "bf16"):
        for batch in (1, 4):
            flagship(dtype, batch, args.iters)
            torch.cuda.empty_cache()
    dau1d(args.iters)


if __name__ == "__main__":
    main()
