"""The enhancement family and the new configs through the port's CLIs, on
the CPU: ``NoisyDataset`` against the JAX package's on both directory
layouts of WAVs written here (the same file lists, splits, lengths and
items, tiled and cropped); ``cli.train_diffsep --config enhancement`` on
such a directory; ``cli.separate`` and ``cli.evaluate`` with each new
config and with ``--sampler ab2``, the NFE each reports, and the configs
against the JAX package's.
"""
import json

import numpy as np
import pytest
import torch

from ditsep_tpu.configs import CONFIG_FAMILIES as JAX_FAMILIES
from ditsep_tpu.data import NoisyDataset as JaxNoisy
from ditsep_tpu_torch.cli import evaluate as eval_cli
from ditsep_tpu_torch.cli import separate as sep_cli
from ditsep_tpu_torch.cli import train_diffsep
from ditsep_tpu_torch.configs import CONFIG_FAMILIES
from ditsep_tpu_torch.data import NoisyDataset, read_wav, write_wav

FS = 16000
LAYOUTS = {
    "valentini": lambda root, part, kind: root / f"{kind}_{part}set_wav",
    "preprocessed": lambda root, part, kind: root / part / kind,
}
# a tiny NCSN++ on a short STFT, no attention (items up to 0.4 s)
TINY = ["model.score_model.nf=16", "model.score_model.ch_mult=(1,1)",
        "model.score_model.num_res_blocks=1",
        "model.score_model.attn_resolutions=()",
        "model.score_model.n_fft=126", "model.score_model.hop_length=32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_corpus(root, layout="valentini", n_train=12, n_test=3, seed=0):
    """Noisy / clean WAV pairs of 0.1-0.4 s at 16 kHz: speech-like clean
    (a modulated tone) plus noise."""
    rng = np.random.default_rng(seed)
    for part, n in (("train", n_train), ("test", n_test)):
        for kind in ("noisy", "clean"):
            LAYOUTS[layout](root, part, kind).mkdir(parents=True)
        for i in range(n):
            t = np.arange(int(rng.integers(1600, 6400))) / FS
            clean = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                     * np.sin(2 * np.pi * 3 * t)).astype(np.float32)
            noisy = clean + 0.05 * rng.standard_normal(t.size).astype(
                np.float32)
            name = f"p{i:03d}_{part}.wav"
            write_wav(str(LAYOUTS[layout](root, part, "clean") / name),
                      clean, FS)
            write_wav(str(LAYOUTS[layout](root, part, "noisy") / name),
                      noisy, FS)
    return root


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("split,len_s", [("train", 0.25), ("val", None),
                                         ("test", None), ("train", None)])
def test_noisy_dataset_matches_jax(tmp_path, layout, split, len_s):
    root = write_corpus(tmp_path, layout)
    kw = dict(path=str(root), split=split, fs=FS, len_s=len_s)
    got, want = NoisyDataset(**kw), JaxNoisy(**kw)
    assert got.files == want.files and len(got) == len(want) > 0
    assert (got.noisy_dir, got.clean_dir) == (want.noisy_dir,
                                              want.clean_dir)
    for i in range(len(got)):
        assert got.item_length(i) == want.item_length(i)
        (gm, gt), (wm, wt) = got[i], want[i]
        assert gm.dtype == gt.dtype == np.float32
        assert gm.shape == (1, got.item_length(i)) and gt.shape[0] == 2
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gt, wt)


def test_noisy_dataset_splits():
    """Validation is a seeded 10% holdout of the train files (at least
    one), disjoint from training; an unknown split raises."""
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as tmp:
        root = write_corpus(Path(tmp), n_train=25)
        train = NoisyDataset(str(root), "train", len_s=None).files
        val = NoisyDataset(str(root), "val", len_s=None).files
        assert len(val) == 2 and not set(train) & set(val)
        assert sorted(train + val) == sorted(
            f.name for f in (root / "noisy_trainset_wav").iterdir())
        small = write_corpus(Path(tmp) / "small", n_train=3, n_test=1)
        assert len(NoisyDataset(str(small), "val", len_s=None)) == 1
    with pytest.raises(ValueError, match="split"):
        NoisyDataset(str(root), "dev")


@pytest.mark.parametrize("name", sorted(CONFIG_FAMILIES))
def test_configs_match_jax(name):
    assert CONFIG_FAMILIES[name]() == JAX_FAMILIES[name]()
    assert set(JAX_FAMILIES) == set(CONFIG_FAMILIES)


def test_cli_train_enhancement_on_cpu(tmp_path):
    root = write_corpus(tmp_path / "vctk", "preprocessed")
    work = tmp_path / "run"
    state = train_diffsep.main([
        "--config", "enhancement", "--cpu", "--data-path", str(root),
        "--batch-size", "2", "--max-steps", "3", "--workdir", str(work),
        "--override", *TINY, "datamodule.max_len_s=0.25",
        "model.sampler.N=2"])
    assert state.step == 3
    vals = [json.loads(ln) for ln in open(work / "metrics.jsonl")
            if "val/si_sdr" in ln]
    assert vals and all(np.isfinite(v["val/si_sdr"])
                        and np.isfinite(v["val/score_loss"]) for v in vals)
    assert (work / "ema.npz").exists()


@pytest.mark.parametrize("config,sampler,nfe", [
    ("diffsep_sb", "pc", 2),       # the bridge sampler: N evaluations
    ("diffsep_sb", "ab2", 2),      # the bridge takes no ab2: the same
    ("diffsep_ouve", "pc", 4),     # PC with ald: N (corrector + 1)
    ("diffsep", "ab2", 2),         # ab2: one evaluation a step
    ("enhancement", "ab2", 2),
])
def test_cli_separate_on_cpu(tmp_path, config, sampler, nfe):
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    fs = 16000 if config == "enhancement" else 8000
    rng = np.random.default_rng(4)
    write_wav(str(inp / "a.wav"),
              0.3 * rng.standard_normal(1200).astype(np.float32), fs)
    got = sep_cli.main(["--config", config, "--input", str(inp),
                        "--output", str(out), "--sampler-N", "2",
                        "--sampler", sampler, "--cpu", "--override", *TINY])
    assert got == nfe
    for s in ("s0", "s1"):
        data, rate = read_wav(str(out / s / "a.wav"))
        assert rate == fs and data.shape == (1200,)
        assert np.isfinite(data).all()


@pytest.mark.parametrize("config,sampler,nfe", [
    ("diffsep_sb", "ab2", 2),  # the JAX CLI's count: N for ab2
    ("diffsep_sb", "pc", 4),   # and N (corrector + 1) else, SB included
    ("enhancement", "pc", 4),
])
def test_cli_evaluate_on_cpu(tmp_path, config, sampler, nfe):
    """The summary's ``nfe`` is the JAX evaluate CLI's formula, which
    counts N (corrector steps + 1) for every run but ab2, the bridge
    sampler's N evaluations included (ROADMAP C, reference behaviours).
    enhancement scores the VCTK-DEMAND test split under --data-path."""
    data = (["--data-path", str(write_corpus(tmp_path / "vctk"))]
            if config == "enhancement"
            else ["--synthetic", "--synthetic-items", "2",
                  "--synthetic-len-s", "0.3"])
    res = eval_cli.main(["--config", config, "--cpu", *data,
                         "--eval-batch-size", "2", "--sampler-N", "2",
                         "--sampler", sampler, "--out-dir",
                         str(tmp_path / "out"), "--override", *TINY])
    summary = res["summary"]
    assert summary["nfe"] == nfe
    assert summary["number"] == len(res["results"]) > 0
    assert np.isfinite(summary["si_sdr"])
