"""The port's evaluation harness (ditsep_tpu_torch.eval.evaluate and
cli.evaluate) against the JAX package's, on the CPU: bucket assignment
(exact), ``evaluate_dataset`` with one deterministic numpy separator on
both sides (the JSON files key for key and in order, every value but
``runtime`` within 1e-6 abs, the same lengths passed), the evaluate CLI at
a tiny size (PC and ab2), and the flags that are not ported yet.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.data import SyntheticMixDataset as JaxSynthetic
from ditsep_tpu.eval import evaluate as jax_evaluate
from ditsep_tpu_torch.cli import evaluate as cli
from ditsep_tpu_torch.data import SyntheticMixDataset
from ditsep_tpu_torch.eval import evaluate

# no attention above the U-Net's fourth level: the items are 2-6 s long
TINY = ["model.score_model.nf=16", "model.score_model.ch_mult=(1,1,1,1)",
        "model.score_model.num_res_blocks=1",
        "model.score_model.attn_resolutions=()",
        "model.score_model.n_fft=126", "model.score_model.hop_length=32"]
SUMMARY_KEYS = ["batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi",
                "nfe", "runtime", "len_s", "number", "pesq_impl",
                "merged_utterances"]
ITEM_KEYS = ["batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi",
             "pesq_impl", "nfe", "runtime", "len_s"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_buckets", [1, 2, 3, 24])
def test_bucketing_matches_jax(seed, max_buckets):
    rng = np.random.default_rng(seed)
    lengths = [int(v) for v in rng.integers(1000, 60000, 17)]
    spec = (510, 128, 64)
    got = evaluate._bucket_lengths_frames(lengths, spec, max_buckets)
    want = jax_evaluate._bucket_lengths_frames(lengths, spec, max_buckets)
    assert got[0] == want[0] and got[1] == want[1]
    got = evaluate._bucket_lengths(lengths, 4096, max_buckets)
    want = jax_evaluate._bucket_lengths(lengths, 4096, max_buckets)
    assert got[0] == want[0] and got[1] == want[1]
    if max_buckets == 1:  # everything pads to the longest
        assert set(got[0].values()) == {max(-(-v // 4096) * 4096
                                             for v in lengths)}


def _separator(record):
    """A deterministic separator on numpy: source 0 is 0.7 of the mix plus
    a shifted copy, source 1 the rest. It ignores the key and the
    generator and records the lengths it is given."""
    def run(mix, lens):
        if lens is not None:
            record.append([int(v) for v in np.asarray(lens)])
        s0 = 0.7 * mix + 0.1 * np.roll(mix, 3, axis=-1)
        return np.concatenate([s0, mix - s0], axis=1).astype(np.float32)

    def port_fn(mix, lengths=None, generator=None):
        assert isinstance(generator, torch.Generator)
        return torch.from_numpy(run(mix.numpy(), lengths))

    def jax_fn(key, mix, *lens):
        return jnp.asarray(run(np.asarray(mix), lens[0] if lens else None))

    return port_fn, jax_fn


def _same_json(a, b):
    """Key for key and in order; every value but ``runtime`` within 1e-6
    abs (strings and booleans equal)."""
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            if k != "runtime":
                _same_json(a[k], b[k])
    elif isinstance(b, (str, bool)):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame_spec,max_buckets,pass_lengths", [
    ((126, 32, 64), 8, True), ((126, 32, 64), 1, False), (None, 2, True)],
    ids=["frame_blocks", "frame_blocks_merged", "sample_buckets"])
def test_evaluate_dataset_matches_jax(tmp_path, frame_spec, max_buckets,
                                      pass_lengths):
    kw = dict(n_items=5, min_len_s=0.45, max_len_s=1.1, seed=3)
    rec_port, rec_jax = [], []
    port_fn, _ = _separator(rec_port)
    _, jax_fn = _separator(rec_jax)
    common = dict(fs=8000, batch_size=2, bucket_multiple=2048,
                  frame_spec=frame_spec, max_buckets=max_buckets, nfe=4,
                  split_name="synthetic_test", seed=0,
                  pass_lengths=pass_lengths, save_samples=2)
    got = evaluate.evaluate_dataset(port_fn, SyntheticMixDataset(**kw),
                                    out_dir=str(tmp_path / "port"),
                                    device="cpu", **common)
    want = jax_evaluate.evaluate_dataset(jax_fn, JaxSynthetic(**kw),
                                         out_dir=str(tmp_path / "jax"),
                                         **common)
    assert rec_port == rec_jax and bool(rec_port) == pass_lengths
    for name in ("synthetic_test.json", "synthetic_test_summary.json"):
        _same_json(json.loads((tmp_path / "port" / name).read_text()),
                   json.loads((tmp_path / "jax" / name).read_text()))
    summary = got["summary"]
    assert list(summary)[:len(SUMMARY_KEYS)] == SUMMARY_KEYS
    assert list(got["results"]["0"])[:len(ITEM_KEYS)] == ITEM_KEYS
    assert summary["pesq_impl"] == "p862_numpy"
    if max_buckets == 8:  # under the cap: every item in its own block
        assert summary["merged_utterances"] == 0
    if max_buckets == 1:
        assert summary["merged_utterances"] > 0
    n_calls = sum(-(-n // 2) + 1 for n in got["buckets"].values())
    assert got["calls"] == n_calls
    for i in range(2):
        for s in range(2):
            assert (tmp_path / "port" / "synthetic_test_media"
                    / f"{i:04d}.enh{s}.wav").exists()


def _schema(out_dir):
    per = json.loads((out_dir / "librimix_test.json").read_text())
    summary = json.loads((out_dir / "librimix_test_summary.json")
                         .read_text())
    assert list(summary)[:len(SUMMARY_KEYS)] == SUMMARY_KEYS
    for entry in per.values():
        assert list(entry)[:len(ITEM_KEYS)] == ITEM_KEYS
        assert all(np.isfinite(entry[k]).all()
                   for k in ("si_sdr", "pesq", "stoi"))
    return per, summary


@pytest.mark.parametrize("mode", ["unmasked", "mask_padding", "no_proc",
                                  "ab2"])
def test_cli_evaluate_on_cpu(tmp_path, mode):
    args = ["--config", "diffsep", "--cpu", "--synthetic",
            "--synthetic-items", "2", "--eval-batch-size", "2",
            "--sampler-N", "2", "--out-dir", str(tmp_path), "--override",
            *TINY]
    if mode == "mask_padding":
        args.insert(0, "--mask-padding")
    if mode == "no_proc":
        args.insert(0, "--no-proc")
    if mode == "ab2":
        args[:0] = ["--sampler", "ab2"]
    res = cli.main(args)
    per, summary = _schema(tmp_path)
    assert summary["number"] == len(per) == 2
    assert summary["nfe"] == {"no_proc": 0, "ab2": 2}.get(mode, 4)
    assert summary["pesq_impl"] == "p862_numpy"
    if mode != "no_proc":  # 3.0 and 4.0 s: two frame blocks
        assert len(res["buckets"]) == 2
        assert res["calls"] == sum(-(-n // 2) + 1
                                   for n in res["buckets"].values())


@pytest.mark.parametrize("flag", [["--latent", "--mesh"], ["--mesh"],
                                  ["--config", "ldm", "--mesh"],
                                  ["--save-figures", "1"]])
def test_unported_evaluate_flags_raise(tmp_path, flag, monkeypatch):
    """--mesh without a card and without --cpu raises (no fallback to the
    CPU). --save-figures, once unported, now runs: the first item's
    spectrogram PDF beside the results, no figure failed."""
    if "--mesh" in flag:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--synthetic", "--out-dir", str(tmp_path), *flag])
        return
    pytest.importorskip("matplotlib")
    res = cli.main(["--cpu", "--synthetic", "--synthetic-items", "2",
                    "--eval-batch-size", "2", "--sampler-N", "1",
                    "--out-dir", str(tmp_path), *flag, "--override", *TINY])
    media = tmp_path / "librimix_test_media"
    assert sorted(p.name for p in media.iterdir()) == ["0000.pdf"]
    assert res["media_failures"] == 0


def test_evaluate_dataset_limit_without_warmup_matches_jax(tmp_path):
    """``limit`` scores the first items only, and ``warmup=False`` makes
    one call a batch: the same files as the JAX package's."""
    kw = dict(n_items=6, min_len_s=0.45, max_len_s=1.1, seed=5)
    port_fn, jax_fn = _separator([])
    common = dict(fs=8000, batch_size=2, frame_spec=(126, 32, 64),
                  max_buckets=8, nfe=4, split_name="synthetic_test",
                  limit=3, warmup=False)
    got = evaluate.evaluate_dataset(port_fn, SyntheticMixDataset(**kw),
                                    out_dir=str(tmp_path / "port"),
                                    device="cpu", **common)
    jax_evaluate.evaluate_dataset(jax_fn, JaxSynthetic(**kw),
                                  out_dir=str(tmp_path / "jax"), **common)
    for name in ("synthetic_test.json", "synthetic_test_summary.json"):
        _same_json(json.loads((tmp_path / "port" / name).read_text()),
                   json.loads((tmp_path / "jax" / name).read_text()))
    assert got["summary"]["number"] == len(got["results"]) == 3
    assert sum(got["buckets"].values()) == 3
    assert got["calls"] == sum(-(-n // 2) for n in got["buckets"].values())
