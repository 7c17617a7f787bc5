"""``--mesh`` through the CLIs over two gloo ranks on the CPU, launched as a
user launches them (``python -m torch.distributed.run --nproc-per-node 2
-m ditsep_tpu_torch.cli.<name> --mesh --cpu``), against the plain CLI run
on the same global batch, at a tiny width.

* cli.train_diffsep, 2 steps of a global batch of 2 (1 a rank) and a
  validation: rank 0 alone writes (one line a log event, one checkpoint
  index); the validation 1e-4 relative; after the 2 steps the
  parameters within 2 * 2 * lr and the EMA within that times (1 - decay)
  plus 2 float32 ulps (the train-step bar where the gradient is not
  significant, the loosest), every checkpointed tensor present.
* cli.evaluate: tests/test_torch_parallel_cli_eval.py.

Each launch runs under a hard timeout, on a free port.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ditsep_tpu_torch.parallel import free_port

REPO = Path(__file__).resolve().parents[1]
TINY = ["model.score_model.nf=8", "model.score_model.ch_mult=(1,2)",
        "model.score_model.num_res_blocks=1",
        "model.score_model.attn_resolutions=()", "model.sampler.N=2"]
TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(module, args, nproc=None):
    """``python -m module args`` from the repository, under
    ``torch.distributed.run`` with ``nproc`` ranks when given."""
    launcher = [] if nproc is None else [
        "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
        str(nproc), "--master-addr", "127.0.0.1", "--master-port",
        str(free_port())]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, *launcher, "-m", module, *args],
                         cwd=str(REPO), env=env, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]


def test_train_cli_over_two_gloo_ranks(tmp_path):
    args = ["--cpu", "--synthetic", "--synthetic-items", "4",
            "--synthetic-len-s", "0.3", "--batch-size", "2", "--max-steps",
            "2", "--override", *TINY, "--workdir"]
    run("ditsep_tpu_torch.cli.train_diffsep",
        ["--mesh", *args, str(tmp_path / "two")], nproc=2)
    run("ditsep_tpu_torch.cli.train_diffsep", [*args, str(tmp_path / "one")])
    logs = {k: [json.loads(ln) for ln in
                open(tmp_path / k / "metrics.jsonl")] for k in ("one", "two")}
    assert len(logs["two"]) == len(logs["one"]) >= 1
    for a, b in zip(logs["two"], logs["one"]):
        assert set(a) == set(b) and a["step"] == b["step"]
        for k in set(a) - {"step", "time"}:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    index = {k: json.loads((tmp_path / k / "checkpoints" / "index.json")
                           .read_text()) for k in ("one", "two")}
    assert len(index["two"]) == len(index["one"]) == 1
    state = {k: torch.load(tmp_path / k / "checkpoints" / "latest" /
                           "state.pt", weights_only=False)
             for k in ("one", "two")}
    assert state["two"]["step"] == state["one"]["step"] == 2
    lr, decay = 2e-4, 0.999  # the diffsep config's
    bar = 2 * 2 * lr
    for part, scale in (("model", 1.0), ("ema", 1 - decay)):
        want, got = state["one"][part], state["two"][part]
        assert set(got) == set(want)
        for k, w in want.items():
            w, g = w.numpy(), got[k].numpy()
            slack = 2 * np.spacing(np.abs(w).astype(np.float32))
            assert (np.abs(g - w) <= bar * scale + slack).all(), (part, k)
    ema = [np.load(tmp_path / k / "ema.npz") for k in ("one", "two")]
    assert sorted(ema[0].files) == sorted(ema[1].files)
