"""The port's long-form separation (ditsep_tpu_torch.inference) against
the JAX package's, on the CPU: ``align_permutation`` (the same
permutations), ``separate_longform`` with an oracle separator that swaps
the sources of some windows (outputs within 1e-6 abs, the same
permutations chosen), the right-aligned tail, the single window's pad and
trim, ``pass_lengths``, the argument checks, and ``cli.separate
--chunk-seconds`` at a tiny size.
"""
import numpy as np
import pytest
import torch

from ditsep_tpu.inference import longform as jax_longform
from ditsep_tpu_torch.data import read_wav, write_wav
from ditsep_tpu_torch.inference import (align_permutation,
                                        separate_longform)
from ditsep_tpu_torch.inference import longform

RNG = np.random.default_rng(0)
T = 20000
S = np.stack([RNG.standard_normal(T), RNG.standard_normal(T)]
             ).astype(np.float32)
MIX = S.sum(axis=0)
TINY = ["model.score_model.nf=16", "model.score_model.ch_mult=(1,1)",
        "model.score_model.num_res_blocks=1",
        "model.score_model.attn_resolutions=(128,)",
        "model.score_model.n_fft=126", "model.score_model.hop_length=32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oracle_np(chunk):
    """(1, 1, C) window -> (1, 2, C): the true sources of that window,
    swapped when the window starts in an odd thousand (a single padded
    window is found by its valid part)."""
    c = np.asarray(chunk).reshape(-1)
    n = np.trim_zeros(c, "b").shape[0]
    for s in range(T - n + 1):
        if MIX[s] == c[0] and np.array_equal(MIX[s:s + n], c[:n]):
            break
    else:
        raise AssertionError("window not found in the mixture")
    out = np.zeros((2, c.shape[0]), np.float32)
    out[:, :n] = S[:, s:s + n]
    return (out[::-1] if (s // 1000) % 2 else out)[None].copy()


def _port_oracle(chunk, lengths=None, generator=None):
    assert isinstance(generator, torch.Generator)
    return torch.from_numpy(_oracle_np(chunk.numpy()))


def _jax_oracle(key, chunk):
    return _oracle_np(chunk)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _global_perm_error(est, ref=S):
    return min(np.abs(est - ref).max(), np.abs(est[::-1] - ref).max())


@pytest.mark.parametrize("n", [2, 3])
def test_align_permutation_matches_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(20):
        a = rng.standard_normal((n, 300))
        b = a[rng.permutation(n)] + 0.8 * rng.standard_normal((n, 300))
        assert align_permutation(a, b) == jax_longform.align_permutation(a, b)
    a = S[:, :500]
    assert align_permutation(a, a[::-1]) == (1, 0)


def _recording(monkeypatch, module):
    perms = []
    real = module.align_permutation

    def rec(prev, cur):
        perms.append(real(prev, cur))
        return perms[-1]

    monkeypatch.setattr(module, "align_permutation", rec)
    return perms


@pytest.mark.parametrize("chunk,overlap", [(6000, 1000), (6000, 500),
                                           (7000, 2500)])
def test_separate_longform_matches_jax(monkeypatch, chunk, overlap):
    got_perms = _recording(monkeypatch, longform)
    want_perms = _recording(monkeypatch, jax_longform)
    got = separate_longform(_port_oracle, MIX, chunk_samples=chunk,
                            overlap_samples=overlap, n_src=2,
                            generator=_gen(1), device="cpu")
    want = jax_longform.separate_longform(
        _jax_oracle, MIX, chunk_samples=chunk, overlap_samples=overlap,
        n_src=2, seed=1)
    assert got.shape == want.shape == (2, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got_perms == want_perms and (1, 0) in got_perms
    assert _global_perm_error(got) < 1e-5


def test_right_aligned_tail_covers_everything():
    # chunk 6000, hop 5500: 0, 5500, 11000, then a tail at 14000
    assert longform.window_starts(T, 6000, 500) == [0, 5500, 11000, 14000]
    assert longform.window_starts(16000, 6000, 1000) == [0, 5000, 10000]
    assert longform.window_starts(3000, 6000, 1000) == [0]
    calls = []

    def fn(chunk, lengths=None, generator=None):
        calls.append(chunk.shape)
        return _port_oracle(chunk, generator=generator)

    est = separate_longform(fn, MIX, chunk_samples=6000,
                            overlap_samples=500, n_src=2,
                            generator=_gen(), device="cpu")
    assert calls == [(1, 1, 6000)] * 4
    assert _global_perm_error(est) < 1e-5


def test_single_window_pads_and_trims():
    short = MIX[:3000]
    got = separate_longform(_port_oracle, short, chunk_samples=6000,
                            overlap_samples=1000, generator=_gen(),
                            device="cpu")
    want = jax_longform.separate_longform(_jax_oracle, short,
                                          chunk_samples=6000,
                                          overlap_samples=1000)
    assert got.shape == (2, 3000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert _global_perm_error(got, S[:, :3000]) < 1e-5


def test_pass_lengths_gives_the_valid_count():
    got = []

    def fn(chunk, lengths=None, generator=None):
        got.append(lengths.tolist())
        assert lengths.dtype == torch.int64
        return torch.cat([chunk, chunk], dim=1)

    est = separate_longform(fn, MIX[:3000], chunk_samples=6000,
                            overlap_samples=1000, pass_lengths=True,
                            generator=_gen(), device="cpu")
    assert est.shape == (2, 3000) and got == [[3000]]
    separate_longform(fn, MIX, chunk_samples=6000, overlap_samples=1000,
                      pass_lengths=True, generator=_gen(), device="cpu")
    assert got[1:] == [[6000]] * 4


def test_argument_checks():
    with pytest.raises(ValueError, match="overlap"):
        separate_longform(_port_oracle, MIX, chunk_samples=1000,
                          overlap_samples=1000, generator=_gen(),
                          device="cpu")
    with pytest.raises(ValueError, match="alignment"):
        separate_longform(_port_oracle, MIX, chunk_samples=6000,
                          overlap_samples=0, n_src=2, generator=_gen(),
                          device="cpu")
    with pytest.raises(ValueError, match="mono"):
        separate_longform(_port_oracle, np.stack([MIX, MIX]),
                          chunk_samples=6000, overlap_samples=1000,
                          generator=_gen(), device="cpu")


@pytest.mark.parametrize("mask_padding", [False, True])
def test_cli_separate_chunked_on_cpu(tmp_path, mask_padding):
    from ditsep_tpu_torch.cli.separate import main
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    rng = np.random.default_rng(4)
    lengths = {"long.wav": 5000, "short.wav": 1500}  # 4 windows; 1 padded
    for name, n in lengths.items():
        write_wav(str(inp / name),
                  0.3 * rng.standard_normal(n).astype(np.float32), 8000)
    args = ["--config", "diffsep", "--input", str(inp), "--output",
            str(out), "--sampler-N", "2", "--cpu", "--chunk-seconds",
            "0.25", "--overlap-seconds", "0.1", "--override", *TINY]
    if mask_padding:
        args.insert(0, "--mask-padding")
    assert main(args) == 4
    for s in ("s0", "s1"):
        for name, n in lengths.items():
            data, fs = read_wav(str(out / s / name))
            assert fs == 8000 and data.shape == (n,)
            assert np.isfinite(data).all()


def _streaming_cli_case(tmp_path, mask_padding):
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    rng = np.random.default_rng(5)
    lengths = {"long.wav": 5000, "short.wav": 1500}  # 4 windows; a tail
    for name, n in lengths.items():
        write_wav(str(inp / name),
                  0.3 * rng.standard_normal(n).astype(np.float32), 8000)
    args = ["--config", "diffsep", "--input", str(inp), "--output",
            str(out), "--sampler-N", "2", "--cpu", "--chunk-seconds",
            "0.25", "--overlap-seconds", "0.1", "--streaming-block-seconds",
            "0.0375", "--override", *TINY]
    if mask_padding:
        args.insert(0, "--mask-padding")
    return inp, out, lengths, args


@pytest.mark.parametrize("mask_padding", [False, True])
def test_cli_separate_streaming_on_cpu(tmp_path, monkeypatch, mask_padding):
    """cli.separate --chunk-seconds --streaming-block-seconds: stems of the
    input's length, equal to StreamingSeparator driven directly with the
    CLI's trainer, generator and blocks (bit for bit, before the WAV's
    16-bit quantization)."""
    from ditsep_tpu_torch.cli import separate as cli
    from ditsep_tpu_torch.cli.common import load_config
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.serving import StreamingSeparator

    inp, out, lengths, args = _streaming_cli_case(tmp_path, mask_padding)
    written = {}
    real_write = cli.write_wav

    def capture(path, data, fs):
        written[path] = np.array(data)
        real_write(path, data, fs)

    monkeypatch.setattr(cli, "write_wav", capture)
    assert cli.main(args) == 4

    cfg = load_config("diffsep", TINY)
    cfg["model"]["score_model"]["mask_padding"] = mask_padding
    trainer = build_diffsep_trainer(cfg, device="cpu", seed=0)
    gen = _gen(0)

    def sep(mix, lengths=None, generator=None):
        return trainer.separate(mix, N=2, lengths=lengths,
                                generator=generator)[0]

    for name in sorted(lengths):
        mix, _ = read_wav(str(inp / name))
        stream = StreamingSeparator(sep, chunk_samples=2000,
                                    overlap_samples=800, n_src=2,
                                    generator=gen, device="cpu",
                                    pass_lengths=mask_padding)
        pieces = [stream.push(mix[s:s + 300])
                  for s in range(0, mix.shape[-1], 300)]
        pieces.append(stream.flush())
        want = cli.scale_output(mix[None], np.concatenate(pieces, axis=-1))
        for i, src in enumerate(("s0", "s1")):
            got = written[str(out / src / name)]
            assert got.shape == (lengths[name],)
            assert np.isfinite(got).all()
            np.testing.assert_array_equal(got, want[i])
            data, fs = read_wav(str(out / src / name))
            assert fs == 8000 and data.shape == (lengths[name],)


def test_cli_separate_streaming_requires_chunk_seconds(tmp_path, capsys):
    from ditsep_tpu_torch.cli.separate import main
    with pytest.raises(SystemExit) as e:
        main(["--input", str(tmp_path), "--output", str(tmp_path), "--cpu",
              "--streaming-block-seconds", "0.5"])
    assert e.value.code == 2
    assert "requires --chunk-seconds" in capsys.readouterr().err
