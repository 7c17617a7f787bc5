"""The port's streaming benchmark (ditsep_tpu_torch/scripts/streaming_bench.py)
on the CPU at a tiny size (nf=16, N=2, 3 s of stream): one JSON line with
the keys of the JAX script's result (read from scripts/streaming_bench.py's
source, which is not run: it needs the TPU's JAX and writes
docs/streaming_bench.json), no file written unless --out is given,
docs/streaming_bench.json untouched, and the windows' NFE."""
import ast
import hashlib
import json
import os
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--cpu", "--nf", "16", "--sampler-N", "2", "--f32"]


def _jax_result_keys():
    tree = ast.parse((REPO / "scripts" / "streaming_bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in scripts/streaming_bench.py")


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() \
        else None


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_prints_the_jax_keys_and_writes_nothing(tmp_path, monkeypatch,
                                                capsys):
    from ditsep_tpu_torch.scripts import streaming_bench
    docs = REPO / "docs" / "streaming_bench.json"
    before = _digest(docs)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("STREAM_BENCH_SECONDS", "3")  # the default's source
    result = streaming_bench.main(ARGS)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert list(result) == _jax_result_keys()
    assert result["stream_seconds"] == 3.0
    # 3 s in one 8 s window: the flush's zero-padded window
    assert result["n_windows"] == 1 and result["latency_budget_s"] == 15.0
    assert result["realtime_factor"] > 0 and "the CPU" in result["note"]
    assert "v5e" not in result["note"] and "TPU" not in result["note"]
    assert os.listdir(tmp_path) == [] and _digest(docs) == before

    out = tmp_path / "r.json"
    again = streaming_bench.main(ARGS + ["--stream-seconds", "2", "--out",
                                         str(out)])
    assert again["stream_seconds"] == 2.0
    assert json.loads(out.read_text()).keys() == again.keys()


def test_window_nfe_and_stems():
    """Two windows (10 s of stream): every timed window runs the sampler's
    NFE (2 N with one corrector step), the stream emits every sample."""
    from ditsep_tpu_torch.scripts import streaming_bench
    result, nfe = streaming_bench.run(10.0, nf=16, n_steps=2, dtype="f32",
                                      device="cpu")
    assert result["n_windows"] == 2
    assert nfe == {"warmup": 4, "windows": [4, 4]}
