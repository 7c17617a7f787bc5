"""``cli.evaluate --mesh --cpu`` over two gloo ranks under ``python -m
torch.distributed.run`` against the plain CLI on 3 items at batch 2 (the
effective batch of both): the same results and summary JSONs, every
number within 1e-6 abs, ``runtime`` aside. The launch runs under a hard
timeout, on a free port.
"""
import json

import pytest
import torch

from test_torch_parallel_cli import TINY, run
from test_torch_parallel_eval import _numbers_close


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_evaluate_cli_over_two_gloo_ranks(tmp_path):
    args = ["--cpu", "--synthetic", "--synthetic-items", "3",
            "--synthetic-len-s", "0.5", "--eval-batch-size", "2",
            "--sampler-N", "2", "--override", *TINY, "--out-dir"]
    run("ditsep_tpu_torch.cli.evaluate", ["--mesh", *args,
                                          str(tmp_path / "two")], nproc=2)
    run("ditsep_tpu_torch.cli.evaluate", [*args, str(tmp_path / "one")])
    for name in ("librimix_test.json", "librimix_test_summary.json"):
        got = json.loads((tmp_path / "two" / name).read_text())
        want = json.loads((tmp_path / "one" / name).read_text())
        _numbers_close(got, want, name)
    assert json.loads((tmp_path / "two" / "librimix_test_summary.json")
                      .read_text())["number"] == 3
