"""The LDM decoder finetune's and the VAE sweep's entry points on the CPU:
``cli.cache_latents`` -> ``cli.train_ldm --cpu`` on the tiny latent
config (tests/test_torch_latent.py's), with and without the
discriminator, its metrics, checkpoints and ``--resume``; and
``cli.validate_vae --cpu`` against the JAX package's ``validate_vae`` on
the same ``.npz`` files; both refuse to start without CUDA unless given
``--cpu``.

Tolerances, stated before the runs: ``validate_vae``'s rows, the port's
means against JAX's unrounded ones, SI-SDR 1e-3 dB and MRSTFT 1e-4
relative, the best file the same; the training runs' losses finite.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.cli import validate_vae as jax_validate
from ditsep_tpu.data import SyntheticMixDataset as JaxSynthetic
from ditsep_tpu.models.oobleck import OobleckVAE as JaxVAE
from ditsep_tpu.training import si_sdr_pit as jax_si_sdr_pit
from ditsep_tpu.training.auraloss import (
    multi_resolution_stft_loss as jax_mrstft,
)
from ditsep_tpu_torch.cli import cache_latents, train_ldm, validate_vae
from ditsep_tpu_torch.models.oobleck import OobleckVAE
from test_torch_latent import TINY, _unflat
from test_torch_ldm import seeded_vae_flat

OV = [f"{k}={v!r}" for k, v in TINY.items()] + ["model.sampler.N=2"]
LDM_OV = ["training.loss.spectral.fft_sizes=(256, 128)",
          "training.loss.spectral.hop_sizes=(64, 32)"]
DISC_OV = ["training.loss.discriminator.filters=4",
           "training.loss.discriminator.n_ffts=(256, 128)",
           "training.loss.discriminator.hop_lengths=(64, 32)"]
VAE = {k.split(".")[-1]: v for k, v in TINY.items()
       if k.startswith("model.vae.")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Four cached latents of 0.3 s synthetic items, sampled at N = 2."""
    out = tmp_path_factory.mktemp("cache")
    n = cache_latents.main(["--cpu", "--synthetic", "--synthetic-items", "4",
                            "--synthetic-len-s", "0.3", "--sampler-N", "2",
                            "--out-dir", str(out), "--override", *OV])
    assert n == 4
    return out


def _train(cache, work, *extra):
    return train_ldm.main(["--cpu", "--config", "ldm", "--synthetic",
                           "--latent-cache", str(cache), "--workdir",
                           str(work), "--batch-size", "2", *extra,
                           "--override", *OV, *LDM_OV, *DISC_OV])


@pytest.mark.parametrize("use_disc", [False, True])
def test_cache_latents_then_train_ldm(cache, tmp_path, use_disc):
    """10 steps at batch 2 (5 epochs of the 4 latents): one metrics line at
    step 10, under JAX's keys (step 10 is the discriminator's with
    --use-disc: odd step 9), a top-5 checkpoint a epoch."""
    state = _train(cache, tmp_path, "--max-steps", "10",
                   *(["--use-disc"] if use_disc else []))
    assert state.step == 10
    assert state.gen_optimizer.count == (5 if use_disc else 10)
    lines = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [10]
    keys = ({"train/discriminator_loss"} if use_disc else
            {"train/loss", "train/pit_mrstft_loss", "train/decoded_std"})
    assert set(lines[0]) - {"step", "time"} == keys
    assert all(math.isfinite(v) for v in lines[0].values())
    index = json.loads((tmp_path / "checkpoints" / "index.json").read_text())
    assert len(index) == 5
    assert all(n.startswith("step-") and "_train_loss-" in n for n in index)
    if not use_disc:
        assert all(math.isfinite(v) for v in index.values())


def test_train_ldm_resume_continues_the_step_count(cache, tmp_path):
    first = _train(cache, tmp_path, "--max-steps", "2")
    dec = {k: v.clone() for k, v in first.decoder.state_dict().items()}
    again = _train(cache, tmp_path, "--max-steps", "4", "--resume")
    assert again.step == 4 and again.gen_optimizer.count == 4
    names = json.loads((tmp_path / "checkpoints" / "index.json").read_text())
    assert any(n.startswith("step-00000004") for n in names)
    # the resumed run started from the first run's decoder, not a new one
    assert any(not torch.equal(v, dec[k])
               for k, v in again.decoder.state_dict().items())
    fresh = _train(cache, tmp_path / "fresh", "--max-steps", "2")
    assert all(torch.equal(v, dec[k])
               for k, v in fresh.decoder.state_dict().items())


def _jax_rows(files, n_items):
    """JAX's validate_vae means, unrounded: its loop, on its dataset."""
    vae = JaxVAE(**VAE)
    ds = JaxSynthetic(n_items=n_items)
    rows = []
    for f in files:
        with np.load(f) as data:
            params = {"params": _unflat({k: data[k] for k in data.files})}
        si, mr = [], []
        for i in range(n_items):
            mix, _ = ds[i]
            t = mix.shape[-1] - mix.shape[-1] % vae.downsampling_ratio
            audio = jnp.asarray(mix[None, :, :t])
            rec = vae.apply(params, vae.apply(params, audio,
                                              method=vae.encode),
                            method=vae.decode)
            si.append(float(jnp.mean(jax_si_sdr_pit(rec, audio,
                                                    clamp_db=30.0))))
            mr.append(float(jax_mrstft(rec, audio, fft_sizes=(512, 256),
                                       hop_sizes=(128, 64))))
        rows.append({"ckpt": f.name, "si_sdr": float(np.mean(si)),
                     "mrstft": float(np.mean(mr))})
    return rows


def test_validate_vae_rows_match_jax(tmp_path, capsys):
    for name, seed in (("a.npz", 3), ("b.npz", 4)):
        np.savez(tmp_path / name, **seeded_vae_flat(OobleckVAE(**VAE), seed,
                                                    scale=0.02))
    # one item: JAX's CLI scores eagerly, compiling op by op for each
    # length it sees
    args = ["--params-dir", str(tmp_path), "--n-items", "1", "--synthetic",
            "--override", *OV]
    jax_validate.main(args)
    printed_j = [json.loads(ln) for ln in capsys.readouterr().out.split("\n")
                 if ln.startswith("{")]
    rows = validate_vae.main(["--cpu", *args])
    printed_t = [json.loads(ln) for ln in capsys.readouterr().out.split("\n")
                 if ln.startswith("{")]
    want = _jax_rows(sorted(tmp_path.glob("*.npz")), 1)
    # the replayed loop is what JAX's CLI printed
    assert printed_j[:-1] == [{"ckpt": r["ckpt"],
                               "si_sdr": round(r["si_sdr"], 3),
                               "mrstft": round(r["mrstft"], 4)}
                              for r in want]
    assert [r["ckpt"] for r in rows] == ["a.npz", "b.npz"]
    for got, ref in zip(rows, want):
        assert abs(got["si_sdr"] - ref["si_sdr"]) <= 1e-3, (got, ref)
        assert abs(got["mrstft"] - ref["mrstft"]) <= 1e-4 * abs(ref["mrstft"])
    assert printed_t[-1]["best"]["ckpt"] == printed_j[-1]["best"]["ckpt"]
    assert printed_t[:-1] == [{"ckpt": r["ckpt"],
                               "si_sdr": round(r["si_sdr"], 3),
                               "mrstft": round(r["mrstft"], 4)}
                              for r in rows]


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ldm.main(["--latent-cache", str(tmp_path), "--workdir",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_vae.main(["--params-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no .npz"):
        validate_vae.main(["--cpu", "--params-dir", str(tmp_path)])
