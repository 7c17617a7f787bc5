"""The port's training data, loop, checkpoints and CLI on the CPU.

``SyntheticMixDataset`` and ``BucketedLoader`` give the JAX package's
arrays; ``fit`` writes metrics.jsonl, hparams.json, the checkpoints and
the EMA export, and resumes from the latest checkpoint; the exported EMA
weights load through the JAX package's ``load_params_npz`` and give its
score within 1e-4 * max|ref|; ``cli.train_diffsep --cpu --synthetic``
runs, and refuses what is not ported.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.data import wsj0_mix as jax_data
from ditsep_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.data import wsj0_mix as data
from ditsep_tpu_torch.training.loop import fit
from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_train import TINY

TRAIN_OV = {**TINY, "model.sampler.N": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ov_args():
    return [f"{k}={v!r}" for k, v in TRAIN_OV.items()]


@pytest.mark.parametrize("kw", [{}, {"min_len_s": 0.5, "max_len_s": 0.5},
                                {"n_spkr": 3, "seed": 4}])
def test_synthetic_dataset_matches_jax(kw):
    mine = data.SyntheticMixDataset(n_items=3, **kw)
    ref = jax_data.SyntheticMixDataset(n_items=3, **kw)
    assert len(mine) == len(ref)
    for i in range(len(ref)):
        assert mine.item_length(i) == ref.item_length(i)
        for a, b in zip(mine[i], ref[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loader_kw", [
    dict(batch_size=3, n_buckets=3, multiple=2048, shuffle=True, seed=5),
    dict(batch_size=4, n_buckets=2, multiple=4096, shuffle=False,
         frame_spec=(510, 128, 64), align="left", yield_counts=True),
    dict(batch_size=2, n_buckets=1, multiple=1024, shuffle=True,
         drop_remainder=True),
])
def test_bucketed_loader_matches_jax(loader_kw):
    kw = dict(n_items=7, min_len_s=0.3, max_len_s=1.2)
    mine = data.BucketedLoader(data.SyntheticMixDataset(**kw), **loader_kw)
    ref = jax_data.BucketedLoader(jax_data.SyntheticMixDataset(**kw),
                                  **loader_kw)
    assert mine._bounds == ref._bounds
    got, want = list(mine), list(ref)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert data.length_buckets([100, 900, 5000], 2, 512) == \
        jax_data.length_buckets([100, 900, 5000], 2, 512)


def _tiny_trainer(seed=0):
    return build_diffsep_trainer(override(diffsep(), TRAIN_OV), device="cpu",
                                 seed=seed)


def _datasets():
    kw = dict(min_len_s=0.2, max_len_s=0.2)
    return (data.SyntheticMixDataset(n_items=4, **kw),
            data.SyntheticMixDataset(n_items=2, seed=9, **kw))


def test_fit_writes_its_files_and_resumes(tmp_path):
    work = str(tmp_path / "run")
    train, val = _datasets()
    state = fit(_tiny_trainer(), train, val, workdir=work, batch_size=2,
                max_steps=2, log_every=1)
    assert state.step == 2 and state.optimizer.count == 2
    lines = [json.loads(ln) for ln in open(f"{work}/metrics.jsonl")]
    train_lines = [ln for ln in lines if "train/score_loss" in ln]
    val_lines = [ln for ln in lines if "val/si_sdr" in ln]
    assert [ln["step"] for ln in train_lines] == [1, 2]
    assert all(np.isfinite(ln["train/grad_norm"]) for ln in train_lines)
    assert [ln["step"] for ln in val_lines] == [2]
    assert np.isfinite(val_lines[0]["val/score_loss"])
    hp = json.load(open(f"{work}/hparams.json"))
    assert hp["trainer_cfg"]["init_hack"] == 5 and hp["sde"]["kind"] == \
        "MixSDE" and hp["model"]["n_fft"] == 126
    ckpt = CheckpointManager(f"{work}/checkpoints")
    assert ckpt.latest_path().endswith("latest")
    assert json.load(open(f"{ckpt.latest_path()}/step.json")) == {"step": 2}
    assert ckpt.best_path() and len(ckpt._index) == 1
    assert (tmp_path / "run" / "ema.npz").exists()
    # the restored state is the saved one
    fresh = _tiny_trainer(seed=1).init_state()
    ckpt.restore(fresh, prefer="best")
    assert fresh.step == 2 and fresh.optimizer.count == 2
    for a, b in zip(fresh.ema.state_dict().values(),
                    state.ema.state_dict().values()):
        assert torch.equal(a, b)
    # resume: from step 2 to 3, appending to the same files
    state = fit(_tiny_trainer(seed=1), train, val, workdir=work,
                batch_size=2, max_steps=3, log_every=1, resume=True)
    assert state.step == 3 and state.optimizer.count == 3
    steps = [json.loads(ln)["step"] for ln in open(f"{work}/metrics.jsonl")]
    assert steps[-2:] == [3, 3]  # the train line, then the validation
    assert len(CheckpointManager(f"{work}/checkpoints")._index) == 2


def test_fit_saves_latest_when_training_raises(tmp_path, monkeypatch):
    trainer = _tiny_trainer()
    calls = []
    real = type(trainer).train_step

    def step_then_fail(self, state, batch, **kw):
        if calls:
            raise RuntimeError("boom")
        calls.append(1)
        return real(self, state, batch, **kw)

    monkeypatch.setattr(type(trainer), "train_step", step_then_fail)
    train, _ = _datasets()
    with pytest.raises(RuntimeError, match="boom"):
        fit(trainer, train, None, workdir=str(tmp_path), batch_size=2,
            max_steps=5)
    latest = tmp_path / "checkpoints" / "latest" / "step.json"
    assert json.loads(latest.read_text()) == {"step": 1}


def test_ema_export_loads_into_jax_and_scores_alike(tmp_path):
    from ditsep_tpu_torch.models.weights import save_params_npz
    length = 800
    tt = _tiny_trainer()
    for p in tt.model.parameters():  # away from the zero-init layers
        p.data += 0.05 * torch.randn(p.shape,
                                     generator=torch.Generator().manual_seed(
                                         p.numel()))
    path = str(tmp_path / "ema.npz")
    save_params_npz(path, tt.model)
    jt = jax_build(jax_override(jax_diffsep(), TRAIN_OV))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, length)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, length)))
    params = {"params": jax_load_npz(path, tmpl["params"])}
    rng = np.random.default_rng(3)
    xt = rng.standard_normal((2, 2, length)).astype(np.float32)
    mix = rng.standard_normal((2, 1, length)).astype(np.float32)
    t = np.array([0.4, 0.9], np.float32)
    want = np.asarray(jax.jit(jt.model.apply)(params, jnp.asarray(xt),
                                              jnp.asarray(t),
                                              jnp.asarray(mix)))
    with torch.no_grad():
        got = tt.model.eval()(torch.from_numpy(xt), torch.from_numpy(t),
                              torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # and back into the port, through its own loader
    back = _tiny_trainer(seed=7)
    from ditsep_tpu_torch.models import load_params_npz
    load_params_npz(path, back.model)
    for a, b in zip(back.model.state_dict().values(),
                    tt.model.state_dict().values()):
        assert torch.equal(a, b)


def test_cli_train_diffsep_on_cpu(tmp_path):
    from ditsep_tpu_torch.cli.train_diffsep import main
    work = tmp_path / "cli"
    state = main(["--cpu", "--synthetic", "--synthetic-items", "3",
                  "--synthetic-len-s", "0.2", "--batch-size", "2",
                  "--max-steps", "2", "--workdir", str(work),
                  "--override", *_ov_args()])
    assert state.step == 2 and state.media_failures == 0
    assert (work / "ema.npz").exists() and (work / "metrics.jsonl").exists()
    assert (work / "checkpoints" / "latest" / "state.pt").exists()
    # --mesh in one process without a launcher: a mesh of this device,
    # the plain run bit for bit
    mesh_work = tmp_path / "cli_mesh"
    main(["--cpu", "--mesh", "--synthetic", "--synthetic-items", "3",
          "--synthetic-len-s", "0.2", "--batch-size", "2", "--max-steps",
          "2", "--workdir", str(mesh_work), "--override", *_ov_args()])
    assert ((mesh_work / "ema.npz").read_bytes()
            == (work / "ema.npz").read_bytes())


def test_cli_train_diffsep_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    from ditsep_tpu_torch.cli.train_diffsep import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "--workdir", str(tmp_path)])
