"""The port's SepFormer (models/sepformer.py, cli/sepformer_baseline.py)
against the JAX package's on the CPU, on the tiny config of
tests/test_sepformer.py (its topology scaled down): the chunking at the
gap == K edge (T=368) and a ragged T=403; the forward with the same seeded
flax tree through ``params_from_jax`` (1e-4 max|ref|); the SpeechBrain
importer on the in-repo twin's state dict against JAX's
``sepformer_params_from_torch``; the native CLI's written stems against
JAX's CLI on the same savedir and ``--bucket 64`` (within one int16 step
of the WAVs); ``overlap_add`` (1e-5 abs); the stride refusal."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import init_shapes, load_jax, redraw
from test_sepformer import CFG, _Twin

from ditsep_tpu.models.sepformer import SepFormer as JaxSepFormer
from ditsep_tpu.models.sepformer import overlap_add_chunks as jax_ola_chunks
from ditsep_tpu.models.sepformer import segment_chunks as jax_segment
from ditsep_tpu.models.sepformer import (
    sepformer_params_from_torch as jax_importer)
from ditsep_tpu.ops.stft import overlap_add as jax_overlap_add
from ditsep_tpu_torch.data import read_wav, write_wav
from ditsep_tpu_torch.models.sepformer import (
    SepFormer, overlap_add_chunks, segment_chunks,
    sepformer_params_from_torch, sinusoidal_positional_encoding,
)
from ditsep_tpu_torch.ops.stft import overlap_add

OPS_TOL = 1e-5      # abs, ops
MODEL_TOL = 1e-4    # of max|ref|, the forward
WAV_STEP = 1.0 / 32768  # one int16 step of a written WAV


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mix(T, seed=1, b=2):
    return (np.random.default_rng(seed).normal(size=(b, T)) * 0.1
            ).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("L", [45, 47, 50, 184, 201])
def test_chunking_matches_jax(L):
    """K=10: L=45 (T=368 at kernel 16 / stride 8) has L % K == K // 2 and
    pads a full zero chunk (gap == K), 47 and 201 are ragged, 50 an exact
    multiple; the round trip doubles the signal."""
    x = np.random.default_rng(L).normal(size=(2, L, 3)).astype(np.float32)
    seg, gap = segment_chunks(torch.from_numpy(x), 10)
    jseg, jgap = jax_segment(jnp.asarray(x), 10)
    assert gap == jgap
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    back = overlap_add_chunks(seg, gap)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_ola_chunks(jseg, jgap)))
    np.testing.assert_allclose(back.numpy(), 2 * x, rtol=0, atol=OPS_TOL)


def test_overlap_add_and_positional_table_match_jax():
    rng = np.random.default_rng(3)
    for shape, hop in (((2, 7, 16), 8), ((3, 5, 12), 4), ((4, 24), 24)):
        fr = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(
            overlap_add(torch.from_numpy(fr), hop).numpy(),
            np.asarray(jax_overlap_add(jnp.asarray(fr), hop)), rtol=0,
            atol=OPS_TOL)
    from ditsep_tpu.models.sepformer import (
        sinusoidal_positional_encoding as jax_pe)
    np.testing.assert_array_equal(sinusoidal_positional_encoding(37, 16),
                                  np.asarray(jax_pe(37, 16)))


@pytest.mark.parametrize("T", [368, 403])
def test_forward_matches_jax(T):
    """The same redrawn flax tree in both packages (the port's through
    ``params_from_jax``), T=368 the gap == K edge, 403 ragged."""
    jm = JaxSepFormer(**CFG)
    mix = _mix(T)
    tree = redraw(init_shapes(jm, jnp.asarray(mix)), 5, scale=0.6)
    want = np.asarray(jax.jit(jm.apply)(tree, mix))
    port = load_jax(SepFormer(**CFG), tree)
    with torch.no_grad():
        got = port(torch.from_numpy(mix))
    assert got.shape == want.shape == (2, 2, T) and got.dtype == torch.float32
    assert _rel_err(got, want) <= MODEL_TOL
    with torch.no_grad():  # (B, 1, T) as (B, T)
        assert torch.equal(port(torch.from_numpy(mix)[:, None]), got)


def test_speechbrain_importer_matches_jax():
    """The twin's SpeechBrain-layout state dict: the port's importer keeps
    it as it is (a key check), and its forward equals JAX's model imported
    by JAX's importer from the same dict."""
    torch.manual_seed(0)
    twin = _Twin(CFG).eval()
    state = dict(twin.state_dict())
    port = SepFormer(**CFG)
    loaded = sepformer_params_from_torch({**state, "extra.key": 1.0}, port)
    assert set(loaded) == set(port.state_dict())
    assert all(torch.equal(loaded[k], state[k]) for k in loaded)
    port.load_state_dict(loaded)
    mix = _mix(403, seed=4)
    jm = JaxSepFormer(**CFG)
    want = np.asarray(jax.jit(jm.apply)(jax_importer(state, jm), mix))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(mix))
        twin_out = twin(torch.from_numpy(mix)).numpy()
    assert _rel_err(got, want) <= MODEL_TOL
    assert _rel_err(got, twin_out) <= MODEL_TOL
    del state["masknet.prelu.weight"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        sepformer_params_from_torch(state, port)
    bad = dict(twin.state_dict(), **{"decoder.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="decoder.weight"):
        sepformer_params_from_torch(bad, port)


def test_cli_native_matches_jax_cli(tmp_path, capsys):
    """A SpeechBrain savedir (per-module files): both CLIs on the same
    folder with --bucket 64 write the same stems (the pad changes what
    attention sees, so both pad alike), within one int16 step."""
    from ditsep_tpu.cli.sepformer_baseline import main as jax_main
    from ditsep_tpu_torch.cli.sepformer_baseline import main as port_main
    torch.manual_seed(0)
    twin = _Twin(CFG).eval()
    ckpt = tmp_path / "savedir"
    ckpt.mkdir()
    for mod in ("encoder", "masknet", "decoder"):
        torch.save(getattr(twin, mod).state_dict(), ckpt / f"{mod}.ckpt")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(3)
    for i, n in enumerate((300, 517)):
        write_wav(str(in_dir / f"utt{i}.wav"),
                  (rng.normal(size=n) * 0.1).astype(np.float32), 8000)
    args = ["--input", str(in_dir), "--ckpt", str(ckpt), "--bucket", "64",
            "--model-kwargs", json.dumps(CFG)]
    port_main(args + ["--output", str(tmp_path / "port"), "--cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files"] == 2 and len(summary["file_s"]) == 2
    assert summary["params"] == sum(p.numel() for p in twin.parameters())
    jax_main(args + ["--output", str(tmp_path / "jax")])
    for i, n in enumerate((300, 517)):
        for s in range(2):
            got, fs = read_wav(str(tmp_path / "port" / f"s{s}" /
                                   f"utt{i}.wav"))
            want, _ = read_wav(str(tmp_path / "jax" / f"s{s}" /
                                   f"utt{i}.wav"))
            assert fs == 8000 and got.shape == want.shape == (n,)
            assert np.abs(got - want).max() <= WAV_STEP
            assert np.abs(got).max() > 0.99  # peak-normalized


def test_cli_random_weights_say_so(tmp_path, capsys):
    from ditsep_tpu_torch.cli.sepformer_baseline import main
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write_wav(str(in_dir / "a.wav"), _mix(200, b=1)[0], 8000)
    write_wav(str(in_dir / "b.wav"), _mix(200, b=1)[0], 16000)
    main(["--input", str(in_dir), "--output", str(tmp_path / "o"), "--cpu",
          "--bucket", "64", "--model-kwargs", json.dumps(CFG)])
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and "b.wav: 16000 Hz" in out
    assert json.loads(out.strip().splitlines()[-1])["files"] == 1
    with pytest.raises(SystemExit, match="missing encoder.ckpt"):
        main(["--input", str(in_dir), "--output", str(tmp_path / "o"),
              "--cpu", "--ckpt", str(tmp_path / "o")])


def test_seeded_weights_and_stride_refusal():
    a, b = SepFormer(**CFG), SepFormer(**CFG)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    with pytest.raises(ValueError, match="divide"):
        SepFormer(kernel_size=16, stride=6, enc_channels=8, n_heads=2,
                  d_ffn=16, chunk_size=10, num_dp_layers=1, num_tf_layers=1)
    with pytest.raises(ValueError, match="divide"):
        JaxSepFormer(kernel_size=16, stride=6, enc_channels=8, n_heads=2,
                     d_ffn=16, chunk_size=10, num_dp_layers=1,
                     num_tf_layers=1).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 1, 320)))


def test_published_defaults():
    """sepformer-wsj02mix's hyperparameters, counted on the meta device."""
    with torch.device("meta"):
        m = SepFormer()
    n = sum(p.numel() for p in m.parameters())
    assert 25.5e6 < n < 26.5e6
    assert len(m.masknet.dual_mdl) == 2
    assert len(m.masknet.dual_mdl[0].intra_mdl.mdl.layers) == 8
    assert m.encoder.conv1d.weight.shape == (256, 1, 16)
