"""The demo callbacks against the JAX package's: ``_log_wavs`` and
``SeparationDemoCallback`` log the same tags in the same order with the
same payloads given the same estimates, and with the tiny trainer and
matched noise their stems agree within 1e-3 of max|ref| (the separate
bar); ``make_demo_callbacks`` collates the same demo batch. Then
``--demo-every 1`` through the three training CLIs on the CPU: the demo
audio and the validation media land in the TensorBoard events, and no
callback or media call failed."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.cli.common import make_demo_callbacks as jax_make_demo
from ditsep_tpu.training.demo import SeparationDemoCallback as JaxDemo
from ditsep_tpu.training.demo import _log_wavs as jax_log_wavs
from ditsep_tpu_torch.cli import cache_latents, train_diffsep, train_ldm
from ditsep_tpu_torch.cli import train_diffsep_latent
from ditsep_tpu_torch.cli.common import make_demo_callbacks
from ditsep_tpu_torch.configs import build_latent_trainer, latent_diffsep_ouve
from ditsep_tpu_torch.configs import override
from ditsep_tpu_torch.data import LatentDataset, SyntheticMixDataset
from ditsep_tpu_torch.training.demo import SeparationDemoCallback, _log_wavs
from ditsep_tpu_torch.utils.logging import MetricsLogger, wav_bytes
from tb_events import read_events
from test_torch_latent import TINY as LATENT_TINY
from test_torch_separate import _tiny_pair
from test_torch_train import TINY

pytest.importorskip("tensorboardX")

LATENT_OV = [f"{k}={v!r}" for k, v in LATENT_TINY.items()]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Recorder:
    """A logger that keeps every call."""

    def __init__(self):
        self.calls = []

    def log_audio(self, tag, wav, step, fs=8000):
        self.calls.append((tag, step, fs, np.asarray(wav, np.float32)))

    def guarded(self, what, step, fn, *args, **kwargs):
        fn(*args, **kwargs)

    def log(self, metrics, step):
        self.calls.append(("scalars", step, dict(metrics)))


def _same_calls(got, want, rtol=0.0):
    assert [c[:3] for c in got] == [c[:3] for c in want]
    for g, w in zip(got, want):
        if rtol == 0.0:
            np.testing.assert_array_equal(g[3], w[3])
        else:
            assert np.abs(g[3] - w[3]).max() <= rtol * np.abs(w[3]).max()


def _demo_items(n=3, length=1500, seed=1):
    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal((1, length + 100 * i))).astype(
                 np.float32),
             (0.1 * rng.standard_normal((2, length + 100 * i))).astype(
                 np.float32)) for i in range(n)]


def test_log_wavs_matches_jax():
    a = np.random.default_rng(0).standard_normal((3, 2, 40)).astype(
        np.float32)
    for limit in (2, 5):
        got, want = Recorder(), Recorder()
        _log_wavs(got, "x/y", torch.from_numpy(a), 7, 16000, limit)
        jax_log_wavs(want, "x/y", jnp.asarray(a), 7, 16000, limit)
        assert len(got.calls) == min(limit, 3)
        _same_calls(got.calls, want.calls)


def test_make_demo_callbacks_matches_jax():
    items = _demo_items()
    assert make_demo_callbacks(items, 0) == () == jax_make_demo(items, 0)
    assert make_demo_callbacks([], 5) == () == jax_make_demo([], 5)
    (cb,) = make_demo_callbacks(items, 5, fs=16000)
    (jcb,) = jax_make_demo(items, 5, fs=16000)
    assert (cb.demo_every, cb.sample_rate, cb.max_num_sample) == (
        jcb.demo_every, jcb.sample_rate, jcb.max_num_sample)
    for g, w in zip(cb.demo_batch, jcb.demo_batch):
        np.testing.assert_array_equal(g, w)
    assert [cb.due(s) for s in range(11)] == [jcb.due(s) for s in range(11)]


def test_demo_callback_logs_jax_tags_and_payloads():
    """The same estimates in: the same calls out, bit for bit."""
    items = _demo_items(n=3)
    (cb,) = make_demo_callbacks(items, 2)
    (jcb,) = jax_make_demo(items, 2)
    rng = np.random.default_rng(4)
    est = rng.standard_normal((2, 2, cb.demo_batch[0].shape[-1])).astype(
        np.float32)
    seen = {}

    def port_separate(mix, model=None, generator=None, **kw):
        seen.update(mix=mix, model=model, generator=generator, kw=kw)
        return torch.from_numpy(est), 6

    ema = torch.nn.Linear(1, 1)
    got, want = Recorder(), Recorder()
    g = torch.Generator().manual_seed(0)
    cb(got, 4, types.SimpleNamespace(separate=port_separate),
       types.SimpleNamespace(ema=ema), g)
    jcb(want, 4, types.SimpleNamespace(
        separate=lambda p, k, m, **kw: (jnp.asarray(est), 6)),
        types.SimpleNamespace(ema_params=None), jax.random.PRNGKey(0))
    assert [c[0] for c in got.calls] == [
        "demo/mix/0", "demo/mix/1", "demo/est_0/0", "demo/est_0/1",
        "demo/target_0/0", "demo/target_0/1", "demo/est_1/0",
        "demo/est_1/1", "demo/target_1/0", "demo/target_1/1"]
    _same_calls(got.calls, want.calls)
    assert seen["model"] is ema and seen["generator"] is g
    assert seen["kw"] == {} and seen["mix"].dtype == torch.float32
    # sampler_N goes to the separation as N
    cb_n = SeparationDemoCallback(demo_batch=cb.demo_batch, sampler_N=3)
    cb_n(Recorder(), 1, types.SimpleNamespace(separate=port_separate),
         types.SimpleNamespace(ema=ema), g)
    assert seen["kw"] == {"N": 3}


def test_demo_callback_guards_its_logging_not_its_separation(tmp_path):
    """A separation that fails stops the callback (a kernel's failure
    never disappears); a log call that fails is printed and counted."""
    (cb,) = make_demo_callbacks(_demo_items(n=2), 2)
    state = types.SimpleNamespace(ema=torch.nn.Linear(1, 1))
    g = torch.Generator().manual_seed(0)

    def failing(mix, **kw):
        raise RuntimeError("separation failed")

    logger = MetricsLogger(str(tmp_path))
    with pytest.raises(RuntimeError, match="separation failed"):
        cb(logger, 1, types.SimpleNamespace(separate=failing), state, g)
    assert logger.failures == 0
    est = torch.zeros((2, 2, cb.demo_batch[0].shape[-1]))
    logger.log_audio = failing
    cb(logger, 2, types.SimpleNamespace(separate=lambda mix, **kw: (est, 2)),
       state, g)
    assert logger.failures == 1
    logger.close()


def test_demo_callback_stems_match_jax_with_matched_noise():
    b, length, n = 2, 1500, 3
    jt, params, tt = _tiny_pair(length)
    items = _demo_items(n=b, length=length, seed=5)
    demo = (np.stack([m[..., :length] for m, _ in items]),
            np.stack([t[..., :length] for _, t in items]))
    rng = np.random.default_rng(6)
    noise = (rng.standard_normal((b, 2, length)).astype(np.float32),
             rng.standard_normal((n, 1, b, 2, length)).astype(np.float32),
             rng.standard_normal((n, b, 2, length)).astype(np.float32))
    got, want = Recorder(), Recorder()
    SeparationDemoCallback(demo_batch=demo, sampler_N=n)(
        got, 3, types.SimpleNamespace(
            separate=lambda mix, **kw: tt.separate(mix, noise=noise, **kw)),
        types.SimpleNamespace(ema=tt.model), torch.Generator())
    JaxDemo(demo_batch=demo, sampler_N=n)(
        want, 3, types.SimpleNamespace(
            separate=lambda p, k, m, **kw: jt.separate(p, k, m, noise=noise,
                                                       **kw)),
        types.SimpleNamespace(ema_params=params), jax.random.PRNGKey(0))
    _same_calls(got.calls, want.calls, rtol=1e-3)
    assert sum(c[0].startswith("demo/est") for c in got.calls) == 4


def _tags(workdir):
    return [(e["step"], e["tag"]) for e in read_events(str(workdir / "tb"))
            if e["kind"] != "scalar"]


def _demo_tags(step, n_src=2, n=2, mix=True):
    tags = [(step, f"demo/mix/{i}") for i in range(n)] if mix else []
    for s in range(n_src):
        tags += [(step, f"demo/est_{s}/{i}") for i in range(n)]
        tags += [(step, f"demo/target_{s}/{i}") for i in range(n)]
    return tags


VAL_MEDIA = ["val/mix", "val/est_0", "val/est_1", "val/spectrograms"]


def test_train_diffsep_cli_logs_demos_and_validation_media(tmp_path):
    work = tmp_path / "run"
    state = train_diffsep.main([
        "--cpu", "--synthetic", "--synthetic-items", "3",
        "--synthetic-len-s", "0.2", "--batch-size", "2", "--max-steps", "2",
        "--demo-every", "1", "--workdir", str(work), "--override",
        *[f"{k}={v!r}" for k, v in {**TINY, "model.sampler.N": 2}.items()]])
    assert state.step == 2 and state.media_failures == 0
    # one epoch of two steps: a demo after each, a validation at its end
    assert _tags(work) == (_demo_tags(1) + _demo_tags(2)
                           + [(2, t) for t in VAL_MEDIA])


def test_train_diffsep_latent_cli_logs_demos(tmp_path):
    work = tmp_path / "run"
    state = train_diffsep_latent.main([
        "--cpu", "--synthetic", "--synthetic-items", "3",
        "--synthetic-len-s", "0.3", "--batch-size", "2", "--max-steps", "1",
        "--demo-every", "1", "--workdir", str(work), "--override",
        *LATENT_OV, "model.sampler.N=2"])
    assert state.step == 1 and state.media_failures == 0
    assert _tags(work) == _demo_tags(1) + [(1, t) for t in VAL_MEDIA]
    frames = {e["tag"]: e["frames"] for e in read_events(str(work / "tb"))
              if e["kind"] == "audio"}
    assert frames["demo/est_0/0"] == frames["demo/mix/0"] == 2400


def test_train_ldm_cli_decodes_demos_through_the_live_decoder(tmp_path):
    cache = tmp_path / "cache"
    cache_latents.main(["--cpu", "--synthetic", "--synthetic-items", "2",
                        "--synthetic-len-s", "0.3", "--sampler-N", "2",
                        "--out-dir", str(cache), "--override", *LATENT_OV])
    work = tmp_path / "run"
    state = train_ldm.main([
        "--cpu", "--latent-cache", str(cache), "--workdir", str(work),
        "--batch-size", "2", "--max-steps", "2", "--demo-every", "2",
        "--override", *LATENT_OV,
        "training.loss.spectral.fft_sizes=(256, 128)",
        "training.loss.spectral.hop_sizes=(64, 32)"])
    assert state.step == 2 and state.media_failures == 0
    ev = [e for e in read_events(str(work / "tb")) if e["kind"] == "audio"]
    assert [(e["step"], e["tag"]) for e in ev] == _demo_tags(2, n=1,
                                                             mix=False)
    # the est payload: the cache's first latent through the decoder as
    # training left it; the target: the cache's first target
    cfg = override(latent_diffsep_ouve(), LATENT_TINY)
    lt = build_latent_trainer(cfg, device="cpu")
    lt.vae.decoder.load_state_dict(state.decoder.state_dict())
    tgt, lat = LatentDataset(str(cache), SyntheticMixDataset(
        n_items=2, min_len_s=0.3, max_len_s=0.3))[0]
    with torch.no_grad():
        dec = lt.decode(torch.from_numpy(lat[None]), tgt.shape[-1])[0]
    by_tag = {e["tag"]: e["wav"] for e in ev}
    for s in range(2):
        for tag, x in ((f"demo/est_{s}/0", dec[s].numpy()),
                       (f"demo/target_{s}/0", tgt[s])):
            x = x / max(float(np.abs(x).max()) or 1.0, 1e-8)
            assert by_tag[tag] == wav_bytes(x, 8000), tag
