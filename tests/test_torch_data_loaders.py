"""The port's data loaders (data/dataset.py, data/webdataset.py) against the
JAX package's on the CPU: the same shards, folders and seeds give the same
collated numpy batches bit for bit (every draw is the same random.Random
or numpy draw), epoch after epoch; resampling, the finite mode, the S3
gate and the rank split of shards. Tar shards are written in the test, as
tests/test_webdataset.py writes them."""
import io
import json
import os
import shutil
import tarfile

import jax
import numpy as np
import pytest

from ditsep_tpu.data import dataset as jax_dataset
from ditsep_tpu.data import webdataset as jax_wds
from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.data import dataset as port_dataset
from ditsep_tpu_torch.data import webdataset as port_wds
from ditsep_tpu_torch.data import write_wav


def _make_shard(path, n_items, fs=8000, seed=0, prefix="u", seconds=1.0,
                channels=1, txt=False):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(n_items):
            n = int(seconds * fs) + int(rng.integers(0, fs // 4))
            wav = (rng.standard_normal((channels, n)) * 0.3).astype(
                np.float32)
            tmp = f"{path}.{i}.wav"
            write_wav(tmp, wav[0] if channels == 1 else wav.T, fs)
            tf.add(tmp, arcname=f"{prefix}{i:04d}.wav")
            os.unlink(tmp)
            members = [("json", json.dumps({"idx": i, "caption": f"j{i}"}))]
            if txt:
                members.append(("txt", f"caption {i}"))
            for ext, body in members:
                data = body.encode()
                info = tarfile.TarInfo(f"{prefix}{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def _assert_same_batches(got, want):
    """Batches equal bit for bit, their metadata equal."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g[0].dtype == w[0].dtype == np.float32
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]
        else:
            np.testing.assert_array_equal(g, w)


@pytest.fixture
def shards(tmp_path):
    root = str(tmp_path / "shards")
    for k in range(3):
        _make_shard(f"{root}/s{k}.tar", 5, seed=k, prefix=f"s{k}_u")
    return root


def _wds_pair(configs_of, **kw):
    return (port_wds.WebDatasetDataLoader(configs_of(port_wds), **kw),
            jax_wds.WebDatasetDataLoader(configs_of(jax_wds), **kw))


@pytest.mark.parametrize("resampled", [True, False])
def test_wds_batches_equal_jax_epoch_after_epoch(shards, resampled):
    """Resampled (endless, bounded by epoch_steps) and finite shard
    streams: three epochs of the same loader equal JAX's, and the epochs
    differ from one another."""
    port, ref = _wds_pair(
        lambda m: [m.LocalWebDatasetConfig(id="t", path=shards)],
        sample_rate=8000, sample_size=3000, batch_size=3, shuffle_buffer=4,
        epoch_steps=4, resampled_shards=resampled, seed=3)
    epochs = []
    for _ in range(3):
        got, want = list(port), list(ref)
        _assert_same_batches(got, want)
        epochs.append(got[0][0])
    assert not np.array_equal(epochs[0], epochs[1])
    if not resampled:  # 15 items: 5 full batches, bounded at 4
        assert len(got) == 4


def test_wds_finite_mode_drops_the_partial_batch(tmp_path):
    root = str(tmp_path / "shards")
    _make_shard(f"{root}/s0.tar", 9)
    port, ref = _wds_pair(
        lambda m: [m.LocalWebDatasetConfig(id="t", path=root)],
        sample_size=2000, batch_size=2, shuffle_buffer=4, epoch_steps=100,
        resampled_shards=False)
    got = list(port)
    assert len(got) == 4
    _assert_same_batches(got, list(ref))


def test_wds_resamples_stereo_and_metadata_hooks(tmp_path):
    """16 kHz stereo shards resampled to 8 kHz and folded to mono (and
    kept stereo), a .txt caption beside a .json, a config's metadata hook:
    the batches equal JAX's."""
    shard = _make_shard(str(tmp_path / "s" / "s0.tar"), 6, fs=16000,
                        channels=2, txt=True, seconds=0.5)

    def hook(info, audio):
        return {"n": int(audio.shape[-1]), "key_len": len(info["__key__"])}

    for channels in ("mono", "stereo"):
        port, ref = _wds_pair(
            lambda m: [m.LocalWebDatasetConfig(id="t", path=shard,
                                               custom_metadata_fn=hook)],
            sample_rate=8000, sample_size=5000, batch_size=2,
            shuffle_buffer=2, epoch_steps=3, force_channels=channels)
        got = list(port)
        _assert_same_batches(got, list(ref))
        assert got[0][0].shape == (2, 1 if channels == "mono" else 2, 5000)
        meta = got[0][1][0]
        assert meta["key_len"] == len(meta["__key__"])  # the hook ran
        assert meta["caption"].startswith("j")  # json's caption kept
        assert abs(meta["seconds_total"] - meta["n"] / 8000) < 1e-9


def test_iter_tar_samples_and_resample_equal_jax(tmp_path):
    shard = _make_shard(str(tmp_path / "s" / "s0.tar"), 4, fs=16000,
                        txt=True)
    got = list(port_wds.iter_tar_samples(shard))
    want = list(jax_wds.iter_tar_samples(shard))
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["audio"], w["audio"])
        assert (g["sample_rate"], g["json"]) == (w["sample_rate"], w["json"])
        for fs, target in ((16000, 8000), (16000, 44100), (8000, 22050)):
            np.testing.assert_array_equal(
                port_wds._resample(g["audio"], fs, target),
                jax_wds._resample(w["audio"], fs, target))


def test_resample_lives_in_the_loader_module():
    from ditsep_tpu_torch.inference import utils as inf_utils
    from ditsep_tpu.inference.utils import prepare_audio as jax_prepare
    assert not hasattr(inf_utils, "_resample")
    audio = np.random.default_rng(0).standard_normal((2, 1, 3000)).astype(
        np.float32)
    np.testing.assert_array_equal(
        inf_utils.prepare_audio(audio, 16000, 8000, 1600, 1),
        jax_prepare(audio, 16000, 8000, 1600, 1))


def _audio_dir(tmp_path, n=5):
    adir = tmp_path / "audio"
    (adir / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        d = adir / "sub" if i % 2 else adir
        write_wav(str(d / f"a{i}.wav"),
                  (rng.standard_normal(1500 + 400 * i) * 0.2).astype(
                      np.float32), 8000)
    return adir


@pytest.mark.parametrize("channels", [1, 2])
def test_audio_dir_batches_equal_jax(tmp_path, channels):
    """create_dataloader_from_config('audio_dir'): crops, pads, phase flips
    and the shuffled order equal JAX's over two epochs (the trailing
    partial batch kept)."""
    adir = _audio_dir(tmp_path)
    cfg = {"dataset_type": "audio_dir",
           "datasets": [{"id": "d", "path": str(adir)}]}
    port = port_wds.create_dataloader_from_config(
        cfg, batch_size=2, sample_size=2000, sample_rate=8000,
        audio_channels=channels)
    ref = jax_wds.create_dataloader_from_config(
        cfg, batch_size=2, sample_size=2000, sample_rate=8000,
        audio_channels=channels)
    assert len(port) == len(ref) == 3
    for _ in range(2):
        got = list(port)
        _assert_same_batches(got, list(ref))
    assert got[0][0].shape == (2, channels, 2000)
    assert got[-1][0].shape[0] == 1


def test_pre_encoded_batches_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    for k, sub in enumerate(("a", "b")):
        d = tmp_path / sub
        d.mkdir()
        for i in range(3):
            lat = rng.standard_normal((4, 8)).astype(np.float32)
            if i % 2:
                np.savez(d / f"l{i}.npz", latent=lat)
            else:
                np.save(d / f"l{i}.npy", lat)
    cfg = {"dataset_type": "pre_encoded",
           "datasets": [{"path": str(tmp_path / "a")},
                        {"path": str(tmp_path / "b")}]}
    port = port_wds.create_dataloader_from_config(cfg, 4, 0, 8000)
    ref = jax_wds.create_dataloader_from_config(cfg, 4, 0, 8000)
    for _ in range(2):
        _assert_same_batches(list(port), list(ref))
    with pytest.raises(IndexError):
        port.ds[6]
    with pytest.raises(NotImplementedError):
        port_wds.create_dataloader_from_config({"dataset_type": "nope"},
                                               2, 100, 8000)


def test_wds_from_config_equal_jax(shards):
    cfg = {"dataset_type": "wds", "datasets": [{"id": "a", "path": shards}],
           "epoch_steps": 2, "random_crop": False}
    port = port_wds.create_dataloader_from_config(cfg, 2, 1000, 8000)
    ref = jax_wds.create_dataloader_from_config(cfg, 2, 1000, 8000)
    _assert_same_batches(list(port), list(ref))


def test_augmentations_and_sample_dataset_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((2, 500)).astype(np.float32)
    for fn in ("mono", "stereo"):
        np.testing.assert_array_equal(getattr(port_dataset, fn)(audio),
                                      getattr(jax_dataset, fn)(audio))
        np.testing.assert_array_equal(getattr(port_dataset, fn)(audio[:1]),
                                      getattr(jax_dataset, fn)(audio[:1]))
    for fn in ("phase_flipper", "volume_norm"):
        for seed in range(4):
            np.testing.assert_array_equal(
                getattr(port_dataset, fn)(np.random.default_rng(seed),
                                          audio),
                getattr(jax_dataset, fn)(np.random.default_rng(seed),
                                         audio))
    silent = np.zeros((1, 10), np.float32)
    assert port_dataset.volume_norm(rng, silent) is silent
    for n, rand in ((300, True), (300, False), (800, True)):
        got = port_dataset.PadCropNormalized(n, rand)(
            np.random.default_rng(5), audio)
        want = jax_dataset.PadCropNormalized(n, rand)(
            np.random.default_rng(5), audio)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    adir = _audio_dir(tmp_path)
    kw = dict(paths=[str(adir)], sample_size=1800, force_channels="stereo",
              seed=7)
    port, ref = port_dataset.SampleDataset(**kw), jax_dataset.SampleDataset(
        **kw)
    assert port.files == ref.files and len(port) == 5
    for i in (0, 3, 1, 4):
        (a, m), (b, n) = port[i], ref[i]
        np.testing.assert_array_equal(a, b)
        assert m == n


def test_s3_config_gated_on_aws_cli():
    cfg = port_wds.S3DatasetConfig(id="s", s3_path="s3://bucket/prefix/")
    if shutil.which("aws") is None:
        with pytest.raises(RuntimeError, match="aws CLI"):
            cfg.shard_urls()
    assert cfg._aws("s3", "ls") == ["aws", "s3", "ls"]
    assert port_wds.S3DatasetConfig(id="s", s3_path="s3://b/",
                                    profile="p")._aws("x") == [
        "aws", "--profile", "p", "x"]


@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (2, 3), (3, 5)])
def test_ranks_take_disjoint_shards_as_jax(tmp_path, monkeypatch, rank,
                                           world):
    """Each process reads every world-th shard from its rank (one shard at
    least): the port's rank from parallel.process_index / process_count,
    JAX's from jax.process_index / process_count, patched alike."""
    root = str(tmp_path / "shards")
    for k in range(4):
        _make_shard(f"{root}/s{k}.tar", 1, seed=k)
    monkeypatch.setattr(parallel, "process_index", lambda: rank)
    monkeypatch.setattr(parallel, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    port, ref = _wds_pair(
        lambda m: [m.LocalWebDatasetConfig(id="t", path=root)],
        batch_size=1, sample_size=100, shuffle_buffer=1, epoch_steps=2)
    mine = port._my_shards()
    assert mine == ref._my_shards()
    all_urls = sorted(os.path.join(root, f"s{k}.tar") for k in range(4))
    assert mine == (all_urls[rank::world] or all_urls[:1])
    _assert_same_batches(list(port), list(ref))


def test_process_index_without_a_group():
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)


def test_no_shards_raises(tmp_path):
    dl = port_wds.WebDatasetDataLoader(
        [port_wds.LocalWebDatasetConfig(id="t", path=str(tmp_path))])
    with pytest.raises(FileNotFoundError, match="no .tar shards"):
        list(dl)
    with pytest.raises(ValueError, match="wav"):
        port_wds._decode_audio("x.flac", b"")
