"""Streaming tar-shard ("WebDataset") reader for large-scale training (port of
ditsep_tpu/data/webdataset.py; reference: stable-audio-tools
data/dataset.py:404-960).

Datasets are tar shards of (audio, json) pairs: shards stream in turn,
samples shuffle through a bounded buffer, and the work splits across
processes by shard.

* The tar protocol is the standard library's ``tarfile`` over a file or a
  subprocess pipe; no ``webdataset`` package.
* S3 shells out to the aws CLI (``aws s3 ls`` / ``aws s3 cp <url> -``)
  and raises where it is not installed.
* Each process of a ``torch.distributed`` group reads every world-th
  shard from its rank (``parallel.process_index`` / ``process_count``:
  0 and 1 without a group), where the JAX package keys on
  ``jax.process_index`` / ``process_count``.
* Members decode as WAV (the port's ``read_wav``) and json / txt
  metadata; other codecs raise.

The loaders yield collated numpy batches (audio (B, C, T), a list of
metadata dicts) from the same ``random.Random`` and numpy draws as the
JAX package's, so one seed gives the same batches; the caller moves them
to the device.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import random
import subprocess
import tarfile
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ditsep_tpu_torch.data.dataset import (
    PadCropNormalized, PreEncodedDataset, SampleDataset,
)

_AUDIO_EXTS = (".wav",)


@dataclasses.dataclass(frozen=True)
class LocalWebDatasetConfig:
    """A local ``.tar`` shard, or a directory searched for them."""

    id: str
    path: str
    custom_metadata_fn: Optional[Callable] = None

    def shard_urls(self) -> List[str]:
        if self.path.endswith(".tar"):
            return [self.path]
        out = []
        for root, _, files in os.walk(self.path):
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".tar"))
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class S3DatasetConfig:
    """Shards under an S3 prefix, listed with ``aws s3 ls`` and streamed
    with ``aws s3 cp <url> -``; raises where the aws CLI is absent."""

    id: str
    s3_path: str
    custom_metadata_fn: Optional[Callable] = None
    profile: Optional[str] = None

    def _aws(self, *args) -> List[str]:
        cmd = ["aws"]
        if self.profile:
            cmd += ["--profile", self.profile]
        return cmd + list(args)

    def shard_urls(self) -> List[str]:
        try:
            res = subprocess.run(
                self._aws("s3", "ls", "--recursive", self.s3_path),
                capture_output=True, text=True, timeout=120)
        except FileNotFoundError as e:
            raise RuntimeError(
                "S3 dataset configured but the aws CLI is not installed")\
                from e
        if res.returncode != 0:
            raise RuntimeError(
                f"aws s3 ls {self.s3_path!r} failed "
                f"(exit {res.returncode}): {res.stderr.strip()[:500]}")
        bucket = self.s3_path.split("/")[2]
        return sorted(f"s3://{bucket}/" + line.split()[-1]
                      for line in res.stdout.splitlines()
                      if line.strip().endswith(".tar"))


def _open_shard(url: str, profile: Optional[str] = None):
    """(file object, Popen or None) of a shard path or s3 URL; the caller
    waits for the process after closing the stream."""
    if url.startswith("s3://"):
        cmd = ["aws"] + (["--profile", profile] if profile else [])
        proc = subprocess.Popen(cmd + ["s3", "cp", url, "-"],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return proc.stdout, proc
    return open(url, "rb"), None


def _decode_audio(name: str, payload: bytes):
    """A WAV member's bytes -> ((C, T) float32, sample rate)."""
    if not name.endswith(".wav"):
        raise ValueError(f"unsupported audio member {name!r}: only wav "
                         "decodes (no flac / mp3 decoder is installed)")
    from ditsep_tpu_torch.data.audio import read_wav
    data, fs = read_wav(io.BytesIO(payload))
    if data.ndim == 1:
        data = data[None]
    return np.asarray(data, np.float32), fs


def iter_tar_samples(url: str, profile: Optional[str] = None
                     ) -> Iterator[Dict]:
    """Yield ``{'__key__', 'audio', 'sample_rate', 'json'}`` from one
    shard, members grouped by basename as webdataset groups them. A .txt
    member lands under ``json['caption']`` without overwriting a .json
    member's fields (and the other way round). Samples without audio are
    dropped."""
    fileobj, proc = _open_shard(url, profile)
    try:
        with tarfile.open(fileobj=fileobj, mode="r|*") as tf:
            cur_key, cur = None, {}
            for member in tf:
                if not member.isfile():
                    continue
                base = member.name
                stem, dot, ext = base.rpartition(".")
                ext = dot + ext
                if cur_key is not None and stem != cur_key and cur:
                    if "audio" in cur:
                        yield cur
                    cur = {}
                cur_key = stem
                cur["__key__"] = stem
                payload = tf.extractfile(member).read()
                if ext in _AUDIO_EXTS:
                    cur["audio"], cur["sample_rate"] = _decode_audio(
                        base, payload)
                elif ext == ".json":
                    merged = dict(cur.get("json") or {})
                    merged.update(json.loads(payload.decode("utf-8")))
                    cur["json"] = merged
                elif ext == ".txt":
                    merged = dict(cur.get("json") or {})
                    merged.setdefault("caption", payload.decode("utf-8"))
                    cur["json"] = merged
            if cur and "audio" in cur:
                yield cur
    finally:
        try:
            fileobj.close()
        except Exception:
            pass
        if proc is not None:
            # reap the aws child and report a failed download, which tar
            # sees only as a truncated stream
            try:
                err = (proc.stderr.read() or b"").decode(
                    "utf-8", "replace") if proc.stderr else ""
                rc = proc.wait(timeout=30)
                if rc != 0:
                    warnings.warn(f"aws s3 cp {url!r} exited {rc}: "
                                  f"{err.strip()[:300]}", stacklevel=2)
            except Exception:
                proc.kill()


def _resample(audio: np.ndarray, fs: int, target: int) -> np.ndarray:
    """Polyphase resampling of (C, T) audio from ``fs`` to ``target`` Hz
    (scipy's ``resample_poly``)."""
    from scipy.signal import resample_poly

    g = math.gcd(fs, target)
    return np.asarray(resample_poly(audio, target // g, fs // g, axis=-1),
                      np.float32)


@dataclasses.dataclass
class WebDatasetDataLoader:
    """Streaming loader over tar shards: yields (audio (B, C, T), list of
    metadata). Shards split across processes; with ``resampled_shards``
    they are drawn with replacement (an endless stream that
    ``epoch_steps`` bounds), else each is read once in a shuffled order.
    Samples pass a shuffle buffer, then resampling to ``sample_rate``, the
    channel count and the pad / crop. Each ``__iter__`` is a new epoch
    with its own draws."""

    configs: Sequence
    sample_rate: int = 8000
    sample_size: int = 65536
    batch_size: int = 8
    random_crop: bool = True
    force_channels: str = "mono"
    shuffle_buffer: int = 256
    epoch_steps: int = 2000
    resampled_shards: bool = True
    seed: int = 0

    def _my_shards(self) -> List[str]:
        from ditsep_tpu_torch.parallel import process_count, process_index
        urls: List[str] = []
        self._url_cfg = {}
        for c in self.configs:
            for u in c.shard_urls():
                urls.append(u)
                self._url_cfg[u] = c
        if not urls:
            raise FileNotFoundError("no .tar shards found")
        rank, world = process_index(), process_count()
        return urls[rank::world] or urls[:1]

    def _sample_stream(self) -> Iterator[Dict]:
        # the epoch counter goes into the seed: a new __iter__ does not
        # replay the same shard order, shuffle and crops
        rng = random.Random(self.seed * 1_000_003 + self._epoch)
        shards = self._my_shards()
        while True:
            order = ([rng.choice(shards) for _ in shards]
                     if self.resampled_shards
                     else rng.sample(shards, len(shards)))
            for url in order:
                cfg = self._url_cfg.get(url)
                fn = getattr(cfg, "custom_metadata_fn", None)
                for sample in iter_tar_samples(
                        url, profile=getattr(cfg, "profile", None)):
                    if fn is not None:
                        sample["__custom_fn__"] = fn
                    yield sample
            if not self.resampled_shards:
                return

    def _prepare(self, sample: Dict, rng: np.random.Generator, pad_crop):
        audio = sample["audio"]
        fs = int(sample.get("sample_rate", self.sample_rate))
        if fs != self.sample_rate:
            audio = _resample(audio, fs, self.sample_rate)
        if self.force_channels == "mono" and audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        elif self.force_channels == "stereo" and audio.shape[0] == 1:
            audio = np.repeat(audio, 2, axis=0)
        cropped, rel_start, total = pad_crop(rng, audio)
        meta = dict(sample.get("json", {}))
        meta["seconds_start"] = rel_start * total / self.sample_rate
        meta["seconds_total"] = total / self.sample_rate
        meta["__key__"] = sample.get("__key__")
        fn = sample.get("__custom_fn__")
        if fn is not None:
            # a config's metadata hook: fn(info, audio) merged into info
            extra = fn(meta, audio)
            if extra:
                meta.update(extra)
        return np.asarray(cropped, np.float32), meta

    def __iter__(self):
        self._epoch = getattr(self, "_epoch", -1) + 1
        rng = np.random.default_rng((self.seed, self._epoch))
        pad_crop = PadCropNormalized(self.sample_size,
                                     randomize=self.random_crop)
        buf: List[Dict] = []
        batch_audio: List[np.ndarray] = []
        batch_meta: List[Dict] = []
        steps = 0

        def take(sample):
            audio, meta = self._prepare(sample, rng, pad_crop)
            batch_audio.append(audio)
            batch_meta.append(meta)

        for sample in self._sample_stream():
            if len(buf) < self.shuffle_buffer:
                buf.append(sample)
                continue
            idx = int(rng.integers(len(buf)))
            buf[idx], sample = sample, buf[idx]
            take(sample)
            if len(batch_audio) == self.batch_size:
                yield np.stack(batch_audio), batch_meta
                batch_audio, batch_meta = [], []
                steps += 1
                if steps >= self.epoch_steps:
                    return
        rng.shuffle(buf)
        for sample in buf:
            take(sample)
            if len(batch_audio) == self.batch_size:
                yield np.stack(batch_audio), batch_meta
                batch_audio, batch_meta = [], []
                steps += 1
                if steps >= self.epoch_steps:
                    return


def create_dataloader_from_config(dataset_config: Dict, batch_size: int,
                                  sample_size: int, sample_rate: int,
                                  audio_channels: int = 1,
                                  shuffle: bool = True):
    """The reference's config dispatch: ``dataset_type`` 'audio_dir' |
    'pre_encoded' | 's3' | 'wds'. Returns an iterable of collated numpy
    batches."""
    dataset_type = dataset_config.get("dataset_type")
    assert dataset_type is not None, "dataset_type must be specified"
    force_channels = "mono" if audio_channels == 1 else "stereo"

    if dataset_type == "audio_dir":
        ds = SampleDataset(
            paths=[d["path"] for d in dataset_config["datasets"]],
            sample_size=sample_size,
            random_crop=dataset_config.get("random_crop", True),
            force_channels=force_channels)
        return _simple_loader(ds, batch_size, shuffle)
    if dataset_type == "pre_encoded":
        ds = _Concat([PreEncodedDataset(path=d["path"])
                      for d in dataset_config["datasets"]])
        return _simple_loader(ds, batch_size, shuffle)
    if dataset_type in ("s3", "wds"):
        configs = []
        for c in dataset_config["datasets"]:
            if "s3_path" in c:
                configs.append(S3DatasetConfig(
                    id=c["id"], s3_path=c["s3_path"],
                    profile=c.get("profile")))
            else:
                configs.append(LocalWebDatasetConfig(id=c["id"],
                                                     path=c["path"]))
        return WebDatasetDataLoader(
            configs, sample_rate=sample_rate, sample_size=sample_size,
            batch_size=batch_size,
            random_crop=dataset_config.get("random_crop", True),
            force_channels=force_channels,
            epoch_steps=dataset_config.get("epoch_steps", 2000),
            resampled_shards=dataset_config.get("resampled_shards", True))
    raise NotImplementedError(f"Unknown dataset_type: {dataset_type}")


class _Concat:
    """Map-style datasets one after another (torch's ConcatDataset)."""

    def __init__(self, sets):
        self.sets = sets

    def __len__(self):
        return sum(len(s) for s in self.sets)

    def __getitem__(self, idx):
        for s in self.sets:
            if idx < len(s):
                return s[idx]
            idx -= len(s)
        raise IndexError(idx)


class _simple_loader:
    """A map-style batching loader. Items are (audio, meta) tuples or bare
    arrays; audio stacks, metadata collates into a list. Each ``__iter__``
    is an epoch, shuffled by ``random.Random(seed + epoch)``; the trailing
    partial batch is kept unless ``drop_last``."""

    def __init__(self, ds, batch_size: int, shuffle: bool,
                 drop_last: bool = False, seed: int = 0):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n, b = len(self.ds), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def __iter__(self):
        idxs = list(range(len(self.ds)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idxs)
        self._epoch += 1

        def collate(batch):
            if isinstance(batch[0], tuple):
                return (np.stack([b[0] for b in batch]),
                        [b[1] for b in batch])
            return np.stack(batch)

        batch = []
        for i in idxs:
            batch.append(self.ds[i])
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield collate(batch)
