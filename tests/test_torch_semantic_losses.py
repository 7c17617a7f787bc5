"""The port's semantic feature loss (``training/semantic.py``) and its log
mel and stereo sum-and-difference losses (``training/auraloss.py``)
against the JAX package's on the CPU, inputs made by numpy from a seed.

Bars, stated before the runs: ``semantic_feature_l1`` 1e-6 of |ref| (the
std the population one, as ``jnp.std``); ``mel_filterbank`` bit for bit;
``mel_stft_loss`` and ``sum_and_difference_stft_loss`` (perceptual
weighting on and off) 1e-5 of |ref|. ``HubertLoss`` without torchaudio
(absent here) raises naming it and never returns a value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.training import auraloss as ja
from ditsep_tpu.training import semantic as jsem
from ditsep_tpu_torch.training import auraloss as ta
from ditsep_tpu_torch.training import semantic as tsem


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("ids,weight", [(None, 1.0), ([0, 2], 0.5),
                                        ([1], 2.0)])
def test_semantic_feature_l1_matches_jax(ids, weight):
    fx = [_x((2, 7, 5), i) for i in range(3)]
    fy = [0.5 * _x((2, 7, 5), 10 + i) + fx[i] for i in range(3)]
    want = float(jsem.semantic_feature_l1(fx, fy, ids, weight))
    got = float(tsem.semantic_feature_l1(
        [torch.from_numpy(a) for a in fx], fy, ids, weight))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    # the population std: torch's default (unbiased) would differ
    one = float(tsem.semantic_feature_l1(fx[:1], fy[:1]))
    ref = np.abs(fx[0] - fy[0]).mean() / (fy[0].std(ddof=0) + 1e-5)
    assert abs(one - ref) <= 1e-6 * ref
    with pytest.raises(ValueError, match="no feature layers"):
        tsem.semantic_feature_l1(fx, fy, [7])


def test_hubert_loss_raises_without_its_encoder():
    with pytest.raises(ValueError, match="Unsupported"):
        tsem.HubertLoss(model_name="nope")
    loss = tsem.HubertLoss(feature_ids=[-1])
    assert loss.conv_only
    try:
        import torchaudio  # noqa: F401
    except ImportError:
        assert not loss.available
        with pytest.raises(RuntimeError, match="torchaudio"):
            loss(_x((1, 1, 400), 1), _x((1, 1, 400), 2))


@pytest.mark.parametrize("fs,n_fft,n_mels", [(8000, 512, 40),
                                             (44100, 2048, 128),
                                             (16000, 1024, 80)])
def test_mel_filterbank_is_jax_bits(fs, n_fft, n_mels):
    np.testing.assert_array_equal(ta.mel_filterbank(fs, n_fft, n_mels),
                                  ja.mel_filterbank(fs, n_fft, n_mels))


@pytest.mark.parametrize("fs,fft,hop,mels", [(8000, 512, 128, 40),
                                             (16000, 256, 64, 32)])
def test_mel_stft_loss_matches_jax(fs, fft, hop, mels):
    x, y = _x((2, 2, 3000), 3), _x((2, 2, 3000), 4)
    kw = dict(sample_rate=fs, fft_size=fft, hop_size=hop, n_mels=mels)
    want = float(jax.jit(lambda a, b: ja.mel_stft_loss(a, b, **kw))(x, y))
    got = float(ta.mel_stft_loss(torch.from_numpy(x), torch.from_numpy(y),
                                 **kw))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("perceptual", [False, True])
def test_sum_and_difference_loss_matches_jax(perceptual):
    y = 0.3 * _x((2, 2, 4000), 5)
    x = y + 0.1 * _x((2, 2, 4000), 6)
    kw = dict(fft_sizes=(512, 256, 64), hop_sizes=(128, 64, 16),
              sample_rate=8000, perceptual_weighting=perceptual)
    want = float(jax.jit(lambda a, b: ja.sum_and_difference_stft_loss(
        a, b, **kw))(jnp.asarray(x), jnp.asarray(y)))
    got = float(ta.sum_and_difference_stft_loss(
        torch.from_numpy(x), torch.from_numpy(y), **kw))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    with pytest.raises(ValueError, match="stereo"):
        ta.sum_and_difference_stft_loss(torch.zeros(1, 1, 64),
                                        torch.zeros(1, 1, 64))
