"""The port's stdlib web demo (ditsep_tpu_torch.interface) on the CPU,
mirroring tests/test_web_interface.py: a live ThreadingHTTPServer over
localhost driven with urllib. The separation, autoencoder and generation
routes answer with the bytes of the direct backend calls, the LM route
too (WAV through a DAC pretransform's ``decode_tokens``, or JSON codes
without one); a route whose backend was not given answers 404 "backend not
loaded".

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


VAE_JSON = {"model_type": "autoencoder", "sample_rate": 8000, "model": {
    "encoder": {"type": "oobleck", "config": {
        "in_channels": 1, "channels": 4, "c_mults": [1, 2],
        "strides": [2, 2], "latent_dim": 6}},
    "decoder": {"type": "oobleck", "config": {
        "out_channels": 1, "channels": 4, "c_mults": [1, 2],
        "strides": [2, 2], "latent_dim": 3}},
    "bottleneck": {"type": "vae"}, "latent_dim": 3}}

GEN_JSON = {"model_type": "diffusion_cond", "model": {
    "conditioning": {"cond_dim": 8, "configs": [
        {"id": "seconds_start", "type": "number",
         "config": {"min_val": 0, "max_val": 512}},
        {"id": "seconds_total", "type": "number",
         "config": {"min_val": 0, "max_val": 512}}]},
    "diffusion": {"cross_attention_cond_ids": ["seconds_start",
                                               "seconds_total"],
                  "global_cond_ids": ["seconds_start", "seconds_total"],
                  "type": "dit", "config": {
                      "embed_dim": 16, "depth": 1, "num_heads": 2,
                      "cond_token_dim": 8, "global_cond_dim": 16}},
    "io_channels": 1}}


def _generation_app():
    """A numbers-only conditional DiT from the factory (seeded), its
    zero-initialised layers redrawn so the output depends on them."""
    from ditsep_tpu_torch.interface import GenerationApp
    from ditsep_tpu_torch.models.conditioners import (
        create_multi_conditioner_from_config)
    from ditsep_tpu_torch.models.factory import create_model_from_config

    dit, routing, _ = create_model_from_config(GEN_JSON)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in dit.parameters():
            if not p.any():
                p.normal_(0.0, 0.1, generator=g)
    cond = create_multi_conditioner_from_config(
        GEN_JSON["model"]["conditioning"])
    return GenerationApp(model=dit.eval(), io_channels=1, sample_size=64,
                         routing=routing, conditioner=cond.eval())


@pytest.fixture(scope="module")
def full_server(tmp_path_factory):
    from ditsep_tpu_torch.cli.serve import build_autoencoder_app
    path = tmp_path_factory.mktemp("vae") / "vae.json"
    path.write_text(json.dumps(VAE_JSON))
    srv = DemoServer(separation=_tiny_app(),
                     autoencoder=build_autoencoder_app(str(path),
                                                       device="cpu"),
                     generation=_generation_app(), port=0).start()
    yield srv
    srv.close()


ROUTE_CASES = {
    "autoencoder": "/api/autoencoder?latent_noise=0.1&seed=2",
    "generate": "/api/generate",
    "generate_cond": "/api/generate_cond",
}


@pytest.mark.parametrize("route", sorted(ROUTE_CASES))
def test_generation_and_autoencoder_routes_match_direct_calls(full_server,
                                                              route):
    """Each route answers 200 with a WAV equal, byte for byte, to the
    direct backend call's int16 encoding."""
    srv = full_server
    if route == "autoencoder":
        wav = (np.sin(np.arange(400) / 7.0) * 0.5).astype(np.float32)
        body = encode_wav(wav, 8000)
        direct = srv.autoencoder.process(decode_wav(body)[0],
                                         latent_noise=0.1, seed=2)
        fs = srv.autoencoder.fs
    elif route == "generate":
        body = json.dumps({"steps": 3, "seed": 1}).encode()
        direct = srv.generation.generate_uncond(steps=3, seed=1)[0]
        fs = srv.generation.fs
    else:
        body = json.dumps({"cond": {"seconds_start": 0, "seconds_total": 47},
                           "steps": 3, "cfg_scale": 4.0,
                           "seed": 2}).encode()
        direct = srv.generation.generate_conditional(
            {"seconds_start": np.asarray([0.0], np.float32),
             "seconds_total": np.asarray([47.0], np.float32)},
            steps=3, cfg_scale=4.0, seed=2)[0]
        fs = srv.generation.fs
    with _post(srv, ROUTE_CASES[route], body) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "audio/wav"
        got = r.read()
    assert got == encode_wav(direct, fs)
    assert np.isfinite(decode_wav(got)[0]).all()


def _lm_app(decoder: bool):
    """A seeded 3-codebook LM from the factory, with a small DAC
    pretransform's ``decode_tokens`` (codebooks of 16) or none."""
    from ditsep_tpu_torch.interface import LMApp
    from ditsep_tpu_torch.models import bottleneck, codecs, pretransforms
    from ditsep_tpu_torch.models.factory import create_model_from_config

    lm, _ = create_model_from_config({"model_type": "lm", "model": {"lm": {
        "config": {"n_quantizers": 3, "codebook_size": 16, "embed_dim": 16,
                   "depth": 1, "num_heads": 2}}}})
    decode = None
    if decoder:
        g = torch.Generator().manual_seed(3)
        parts = [codecs.DACEncoderWrapper(d_model=2, strides=(2,)),
                 codecs.DACDecoderWrapper(latent_dim=4, channels=4,
                                          rates=(2,)),
                 bottleneck.DACResidualVQ(4, n_codebooks=3, codebook_size=16,
                                          codebook_dim=2)]
        for m in parts:
            m.reset_parameters(g)
        decode = pretransforms.DACPretransform(*parts).decode_tokens
    return LMApp(lm=lm.eval(), decode_tokens=decode, fs=8000)


@pytest.mark.parametrize("case", ["wav", "codes", "unloaded"])
def test_unloaded_backend_routes_404(server, case):
    """/api/lm answers 200 with the direct ``LMApp.process`` call's WAV
    bytes (a decoder given) or its codes as JSON (none), at the same seed;
    on a server built without an LM (``server``: separation only) it
    answers 404 "backend not loaded"."""
    body = json.dumps({"length": 4, "top_k": 4, "temperature": 0.8,
                       "seed": 3}).encode()
    if case == "unloaded":
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/api/lm", body)
        assert e.value.code == 404
        assert b"backend not loaded" in e.value.read()
        return
    app = _lm_app(decoder=case == "wav")
    srv = DemoServer(lm=app, port=0).start()
    try:
        info = json.loads(urllib.request.urlopen(_url(srv, "/api/info"),
                                                 timeout=30).read())
        assert info["lm"] is True
        with _post(srv, "/api/lm", body) as r:
            assert r.status == 200
            got = r.read()
            ctype = r.headers["Content-Type"]
    finally:
        srv.close()
    direct = app.process(length=4, top_k=4, temperature=0.8, seed=3)
    if case == "wav":
        assert ctype == "audio/wav"
        assert direct.shape == (1, 1, 8)
        assert got == encode_wav(direct.reshape(-1), 8000)
    else:
        assert ctype == "application/json"
        assert direct.shape == (1, 3, 4)
        assert json.loads(got) == {"codes": direct.tolist()}


def test_generate_cond_prompt_string_fails_cleanly(full_server):
    """A JSON prompt passes through as a string, which number conditioners
    cannot take (as in the JAX package): a clean 500 with the error."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(full_server, "/api/generate_cond", json.dumps(
            {"cond": {"seconds_start": "x", "seconds_total": 3},
             "steps": 2}).encode())
    assert e.value.code == 500


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
