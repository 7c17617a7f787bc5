"""The data-parallel paths that need several cards of one host, in one
command, from the root of a checkout:

1. ``dryrun_multichip`` over every card (NCCL, one card a rank);
2. the card tests that need two cards or more, in
   ``tests/test_torch_cuda.py``: a kernel on a card that is not the
   current one, the serving engine split over the cards against the plain
   engine on cuda:0, and two gloo ranks sharing cuda:0;
3. ``cli.train_diffsep --mesh`` at the flagship width (diffsep_icassp,
   seeded weights, 2 items of 40,960 samples a rank, 3 steps) and
   ``cli.evaluate --mesh`` on 8 items, each under ``torch.distributed.run
   --nproc-per-node N``.

    python -m ditsep_tpu_torch.scripts.multicard_checks

Each step runs in a child process under ``STEP_TIMEOUT_S``; one JSON line
a step (its exit code and wall seconds, the tail of its output when it
failed), then a last line ``{"ok": ...}``. Exits 1 if a step failed.
Times are wall times of whole processes, builds included: nothing here
measures speed.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CARD_TESTS = "not_current or over_cards or share_one"
STEP_TIMEOUT_S = 600.0


def _torchrun(n: int, module: str) -> list:
    from ditsep_tpu_torch.parallel import free_port
    return ["-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
            "--master-port", str(free_port()), "-m", module]


def steps(n: int, work: Path) -> list:
    """(name, python arguments) of every step over ``n`` cards."""
    return [
        ("dryrun_nccl", ["-m", "ditsep_tpu_torch.scripts.dryrun_multichip",
                         "--nproc", str(n), "--backend", "nccl"]),
        ("card_tests", ["-m", "pytest", "--noconftest", "-q", "-rs",
                        "tests/test_torch_cuda.py", "-k", CARD_TESTS]),
        ("train_mesh", _torchrun(n, "ditsep_tpu_torch.cli.train_diffsep")
         + ["--mesh", "--config", "diffsep_icassp", "--synthetic",
            "--synthetic-items", str(2 * n), "--synthetic-len-s", "5.12",
            "--batch-size", str(2 * n), "--max-steps", "3", "--override",
            "model.sampler.N=5", "--workdir", str(work / "train")]),
        ("evaluate_mesh", _torchrun(n, "ditsep_tpu_torch.cli.evaluate")
         + ["--mesh", "--config", "diffsep_icassp", "--synthetic",
            "--synthetic-items", "8", "--synthetic-len-s", "2.0",
            "--eval-batch-size", "2", "--sampler-N", "5", "--no-warmup",
            "--out-dir", str(work / "eval")]),
    ]


def main() -> int:
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(json.dumps({"ok": False, "cards": n,
                          "error": "needs two cards or more"}))
        return 1
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, cmd in steps(n, Path(tmp)):
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([sys.executable, *cmd], cwd=str(REPO),
                                      capture_output=True, text=True,
                                      timeout=STEP_TIMEOUT_S)
                rc, out = proc.returncode, proc.stdout + proc.stderr
            except subprocess.TimeoutExpired as e:
                rc = 124
                out = "".join(s if isinstance(s, str) else s.decode(
                    errors="replace") for s in (e.stdout, e.stderr) if s)
            rec = {"step": name, "cards": n, "rc": rc,
                   "wall_s": time.perf_counter() - t0}
            if name == "card_tests":
                rec["summary"] = out.strip().splitlines()[-1:]
            if rc != 0:
                ok = False
                rec["tail"] = out[-3000:]
            print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": ok, "cards": n}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
