"""The port's stdlib web demo (ditsep_tpu_torch.interface) on the CPU,
mirroring tests/test_web_interface.py: a live ThreadingHTTPServer over
localhost driven with urllib. The port has the separation backend; the
autoencoder, generation and LM routes answer 404 "backend not loaded" as
the JAX server does without those backends (ROADMAP A16).

Against the JAX package: the WAV codec (``encode_wav`` byte-equal,
``decode_wav`` equal on 8-, 16- and 32-bit input) and
``SeparationApp.process`` with matched noise (1e-3 max|ref|).
"""
import base64
import io
import json
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.interface import web as jax_web
from ditsep_tpu.utils.checkpoint import save_params_npz as jax_save_npz
from ditsep_tpu_torch.cli.serve import build_separation_app
from ditsep_tpu_torch.configs import diffsep, override
from ditsep_tpu_torch.interface import DemoServer, SeparationApp
from ditsep_tpu_torch.interface.web import decode_wav, encode_wav
from ditsep_tpu_torch.sdes.samplers import pc_generator_noise

TINY = {"model.score_model.nf": 16, "model.score_model.ch_mult": (1, 1),
        "model.score_model.num_res_blocks": 1,
        "model.score_model.attn_resolutions": (),
        "model.score_model.n_fft": 126, "model.score_model.hop_length": 32}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_wav_codec_roundtrip():
    rng = np.random.default_rng(0)
    mono = np.tanh(rng.standard_normal(500)).astype(np.float32) * 0.9
    out, fs = decode_wav(encode_wav(mono, 8000))
    assert fs == 8000 and out.shape == (500, 1)
    np.testing.assert_allclose(out[:, 0], mono, atol=1 / 16000, rtol=0)
    stereo = np.tanh(rng.standard_normal((2, 300))).astype(np.float32)
    out2, fs2 = decode_wav(encode_wav(stereo, 16000))
    assert fs2 == 16000 and out2.shape == (300, 2)
    np.testing.assert_allclose(out2.T, stereo, atol=1 / 16000, rtol=0)


def _raw_wav(pcm: np.ndarray, width: int, fs: int = 8000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(width)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_wav_codec_matches_jax(width):
    """encode_wav byte for byte; decode_wav of 8-, 16- and 32-bit PCM (and
    the error on 24-bit) as JAX's."""
    rng = np.random.default_rng(width)
    x = np.clip(rng.standard_normal((2, 257)) * 0.6, -1.2, 1.2).astype(
        np.float32)
    assert encode_wav(x, 8000) == jax_web.encode_wav(x, 8000)
    assert encode_wav(x[0], 16000) == jax_web.encode_wav(x[0], 16000)
    pcm = {1: lambda: rng.integers(0, 256, (257, 2)).astype("u1"),
           2: lambda: rng.integers(-32768, 32768, (257, 2)).astype("<i2"),
           3: lambda: rng.integers(0, 256, (257, 6)).astype("u1"),
           4: lambda: rng.integers(-2 ** 31, 2 ** 31, (257, 2),
                                   dtype=np.int64).astype("<i4")}[width]()
    payload = _raw_wav(pcm, width) if width != 3 else _raw_wav(
        pcm[:, :2], 3)
    if width == 3:
        with pytest.raises(ValueError, match="width"):
            jax_web.decode_wav(payload)
        with pytest.raises(ValueError, match="width"):
            decode_wav(payload)
        return
    (got, fs), (want, jfs) = decode_wav(payload), jax_web.decode_wav(payload)
    assert fs == jfs == 8000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _tiny_app():
    cfg = override(diffsep(), TINY)
    return build_separation_app(cfg, device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = DemoServer(separation=_tiny_app(), port=0).start()
    yield srv
    srv.close()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _post(server, path, body, timeout=60):
    req = urllib.request.Request(_url(server, path), data=body,
                                 method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def test_index_and_info(server):
    page = urllib.request.urlopen(_url(server, "/"), timeout=30).read()
    assert b"ditsep_tpu" in page
    info = json.loads(urllib.request.urlopen(
        _url(server, "/api/info"), timeout=30).read())
    assert info["separation"] is True
    assert not (info["autoencoder"] or info["generation"]
                or info["generation_cond"] or info["lm"])
    assert info["fs"] == 8000


def test_separate_endpoint(server):
    rng = np.random.default_rng(1)
    wav = encode_wav((rng.standard_normal(2000) * 0.3).astype(np.float32),
                     8000)
    with _post(server, "/api/separate?n_steps=2&seed=3", wav) as r:
        out = json.loads(r.read())
        assert r.headers["Content-Type"] == "application/json"
    assert out["fs"] == 8000 and len(out["sources"]) == 2
    for b64 in out["sources"]:
        src, fs = decode_wav(base64.b64decode(b64))
        assert fs == 8000 and src.shape == (2000, 1)
        assert np.isfinite(src).all()


@pytest.mark.parametrize("path,body", [
    ("/api/autoencoder?latent_noise=0.1", b"RIFF"),
    ("/api/generate", json.dumps({"steps": 3, "seed": 1}).encode()),
    ("/api/generate_cond", json.dumps({"cond": {"prompt": "x"}}).encode()),
    ("/api/lm", json.dumps({"length": 4, "top_k": 4}).encode()),
])
def test_unloaded_backend_routes_404(server, path, body):
    """The autoencoder, generation and LM tests of the JAX package: their
    backends are not ported (ROADMAP A16), so the routes answer 404."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, path, body)
    assert e.value.code == 404
    assert b"backend not loaded" in e.value.read()


def test_unknown_endpoint_and_bad_input(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/nope", b"")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert e.value.code == 404
    # malformed wav -> clean 500 with the error text, server stays up
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/separate", b"not a wav file")
    assert e.value.code == 500
    info = json.loads(urllib.request.urlopen(
        _url(server, "/api/info"), timeout=30).read())
    assert info["separation"]


def test_serve_cli_builds_separation_backend():
    """cli/serve.py's build_separation_app: tiny config -> SeparationApp
    -> a server with only the separation tab live."""
    app = _tiny_app()
    assert isinstance(app, SeparationApp) and app.fs == 8000
    srv = DemoServer(separation=app, port=0).start()
    try:
        info = json.loads(urllib.request.urlopen(
            _url(srv, "/api/info"), timeout=30).read())
        assert info["separation"] and not info["autoencoder"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/api/autoencoder", b"")
        assert e.value.code == 404
    finally:
        srv.close()


def test_separation_app_matches_jax(tmp_path):
    """SeparationApp.process (peak-normalized input and output, the seed's
    generator) against JAX's trainer.separate given the same draws."""
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 900)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, 900)))
    npz = str(tmp_path / "score.npz")
    jax_save_npz(npz, tmpl["params"])
    app = build_separation_app(override(diffsep(), TINY), npz,
                               device="cpu")
    rng = np.random.default_rng(2)
    wav = (0.3 * rng.standard_normal((900, 2))).astype(np.float32)
    n, seed = 2, 4
    got = app.process(wav, n_steps=n, snr=0.3, corrector_steps=1,
                      seed=seed)
    mono = wav.mean(axis=1)
    mix = (mono / np.abs(mono).max())[None, None, :]
    noise = tuple(t.numpy() for t in pc_generator_noise(
        torch.Generator().manual_seed(seed), (1, 2, 900), n))
    est, _ = jt.separate(tmpl, jax.random.PRNGKey(0), jnp.asarray(mix),
                         N=n, snr=0.3, corrector_steps=1, noise=noise)
    want = np.asarray(est[0])
    want = want / np.abs(want).max()
    assert got.shape == want.shape == (2, 900)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
