"""The latent path's entry points on the CPU (``--cpu``) at the tiny size
of tests/test_torch_latent.py: ``cli.train_diffsep_latent``,
``cli.evaluate --latent`` and ``cli.cache_latents``; the cache in the JAX
package's file format, read back by both packages' ``LatentDataset``.
"""
import json

import numpy as np
import pytest
import torch

from ditsep_tpu.data import LatentDataset as JaxLatentDataset
from ditsep_tpu_torch.cli import cache_latents, train_diffsep_latent
from ditsep_tpu_torch.cli import evaluate as eval_cli
from ditsep_tpu_torch.configs import (
    build_latent_trainer, latent_diffsep_ouve, override,
)
from ditsep_tpu_torch.data import LatentDataset, SyntheticMixDataset
from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_evaluate import _schema

TINY = ["model.score_model.nf=16", "model.score_model.ch_mult=(1,2)",
        "model.score_model.attn_resolutions=()",
        "model.score_model.image_size=4", "model.vae.channels=8",
        "model.vae.c_mults=(1,2)", "model.vae.strides=(2,4)",
        "model.vae.latent_dim=4"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    from ditsep_tpu_torch.cli.common import parse_overrides
    return override(latent_diffsep_ouve(), parse_overrides(TINY))


def test_train_diffsep_latent_writes_metrics_and_a_checkpoint(tmp_path):
    work = tmp_path / "run"
    state = train_diffsep_latent.main([
        "--cpu", "--synthetic", "--synthetic-items", "3",
        "--synthetic-len-s", "0.3", "--batch-size", "2", "--max-steps", "2",
        "--workdir", str(work), "--override", *TINY,
        "model.sampler.N=2"])
    assert state.step == 2
    lines = [json.loads(ln) for ln in open(work / "metrics.jsonl")]
    vals = [ln for ln in lines if "val/si_sdr" in ln]
    assert vals and all(np.isfinite(v["val/si_sdr"])
                        and np.isfinite(v["val/score_loss"]) for v in vals)
    assert (work / "ema.npz").exists()
    # the latest checkpoint reloads into a fresh trainer's state
    fresh = build_latent_trainer(_tiny_cfg(), device="cpu",
                                 seed=1).init_state()
    CheckpointManager(str(work / "checkpoints")).restore(fresh,
                                                         prefer="latest")
    assert fresh.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
        assert torch.equal(fresh.ema.state_dict()[k],
                           state.ema.state_dict()[k]), k
    # the score model's EMA export loads as --params
    back = build_latent_trainer(_tiny_cfg(), device="cpu",
                                params_npz=str(work / "ema.npz"))
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, state.ema.state_dict()[k]), k


def test_evaluate_latent_writes_the_reference_schema(tmp_path):
    res = eval_cli.main(["--latent", "--config", "latent_diffsep_ouve",
                         "--cpu", "--synthetic", "--synthetic-items", "3",
                         "--synthetic-len-s", "1.0", "--eval-batch-size",
                         "2", "--sampler-N", "2", "--out-dir",
                         str(tmp_path), "--override", *TINY])
    per, summary = _schema(tmp_path)
    assert summary["number"] == len(per) == 3
    assert summary["nfe"] == 4  # JAX's: N x (corrector steps + 1)
    assert sum(res["buckets"].values()) == 3
    # one bucket of 3 items at batch 2: a warmup and two calls
    assert res["calls"] == 3


@pytest.mark.parametrize("entry", ["evaluate", "train", "cache"])
def test_latent_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path,
                                                  entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--synthetic", "--override", *TINY]
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "evaluate":
            eval_cli.main(["--latent", "--config", "latent_diffsep_ouve",
                           *args])
        if entry == "train":
            train_diffsep_latent.main(["--workdir", str(tmp_path), *args])
        if entry == "cache":
            cache_latents.main(["--out-dir", str(tmp_path), *args])


def test_evaluate_latent_refuses_ab2(tmp_path):
    """As the JAX CLI: the latent path follows the reference's ald PC."""
    with pytest.raises(SystemExit, match="ab2"):
        eval_cli.main(["--latent", "--sampler", "ab2", "--config",
                       "latent_diffsep_ouve", "--cpu", "--synthetic",
                       "--out-dir", str(tmp_path)])


def test_cache_latents_is_read_back_by_both_packages(tmp_path):
    out = tmp_path / "cache"
    n = cache_latents.main([
        "--cpu", "--synthetic", "--synthetic-items", "2",
        "--synthetic-len-s", "0.3", "--n-samples-per-item", "2",
        "--sampler-N", "2", "--out-dir", str(out), "--override", *TINY])
    assert n == 4
    base = SyntheticMixDataset(n_items=2, min_len_s=0.3, max_len_s=0.3)
    ours = LatentDataset(str(out), base)
    theirs = JaxLatentDataset(str(out), base)
    assert len(ours) == len(theirs) == 4
    tl = -(-int(0.3 * 8000) // 8)
    for i in range(4):
        tgt, lat = ours[i]
        jtgt, jlat = theirs[i]
        # the stored crop is the item's own targets
        np.testing.assert_array_equal(tgt, base[i // 2][1])
        np.testing.assert_array_equal(tgt, jtgt)
        np.testing.assert_array_equal(lat, jlat)
        assert lat.shape == (2, 4, tl) and lat.dtype == np.float32
        assert np.isfinite(lat).all()
    # the two samples of one item are two draws
    assert not np.array_equal(ours[0][1], ours[1][1])
    meta = np.load(out / "metadata.npz")
    assert meta["base_indices"].tolist() == [0, 0, 1, 1]
