"""Visualization helpers: spectrogram images, latent PCA point clouds,
reverse-diffusion evolution figures (the port of ditsep_tpu/viz.py).

Each function takes numpy arrays and returns a matplotlib Figure (to log
through ``MetricsLogger.log_figure`` or to save) or an array. The
spectrograms are the port's ``ops.stft`` on CPU tensors. matplotlib is an
optional package: ``available()`` says whether it is installed, and the
figure functions import it when called.
"""
from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np
import torch

from ditsep_tpu_torch.ops.stft import stft


def available() -> bool:
    """Whether matplotlib is installed (the figures need it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _abs_stft(x: np.ndarray, n_fft: int = 510,
              hop: int = 128) -> np.ndarray:
    """|STFT| (F, frames) of a mono waveform, on the CPU."""
    x = torch.from_numpy(np.asarray(x, np.float32).reshape(1, -1))
    return stft(x, n_fft, hop)[0].abs().numpy()


def spectrogram_image(audio: np.ndarray, fs: int = 8000, n_fft: int = 510,
                      hop: int = 128, title: Optional[str] = None):
    """Log-magnitude spectrogram figure of a mono waveform."""
    plt = _mpl()
    x = np.asarray(audio).reshape(-1)
    spec = _abs_stft(x, n_fft, hop)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(20 * np.log10(spec + 1e-8), origin="lower", aspect="auto",
              extent=[0, len(x) / fs, 0, fs / 2], cmap="magma")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [Hz]")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def separation_figure(mix: np.ndarray, est: np.ndarray,
                      target: Optional[np.ndarray] = None, fs: int = 8000):
    """Grid of spectrograms, one a row: the mixture, the estimates (n, T)
    and the targets (n, T) when given."""
    plt = _mpl()
    n_src = est.shape[0]
    rows = 1 + n_src + (target.shape[0] if target is not None else 0)
    fig, axes = plt.subplots(rows, 1, figsize=(8, 2 * rows))

    def show(ax, x, label):
        ax.imshow(20 * np.log10(_abs_stft(x) + 1e-8), origin="lower",
                  aspect="auto", cmap="magma")
        ax.set_ylabel(label)
        ax.set_xticks([])
        ax.set_yticks([])

    show(axes[0], mix, "mix")
    for i in range(n_src):
        show(axes[1 + i], est[i], f"est {i}")
    if target is not None:
        for i in range(target.shape[0]):
            show(axes[1 + n_src + i], target[i], f"ref {i}")
    fig.tight_layout()
    return fig


def diffusion_evolution_figure(trajectory: np.ndarray, fs: int = 8000,
                               n_show: int = 6, source: int = 0):
    """Spectrograms of ``source`` at ``n_show`` evenly spaced steps of a
    reverse-diffusion trajectory (steps, B, n_src, T)."""
    plt = _mpl()
    steps = trajectory.shape[0]
    idxs = np.linspace(0, steps - 1, n_show).astype(int)
    fig, axes = plt.subplots(1, n_show, figsize=(2.2 * n_show, 3))
    for ax, i in zip(axes, idxs):
        spec = _abs_stft(trajectory[i, 0, source])
        ax.imshow(20 * np.log10(spec + 1e-8), origin="lower",
                  aspect="auto", cmap="magma")
        ax.set_title(f"step {i}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def latent_pca_point_cloud(latents: np.ndarray, n_points: int = 2000):
    """3-D scatter of the latent frames (B, D, T) on their first three
    principal axes, at most ``n_points`` of them (a seeded choice)."""
    plt = _mpl()
    z = np.asarray(latents)
    z = z.transpose(0, 2, 1).reshape(-1, z.shape[1])
    if z.shape[0] > n_points:
        z = z[np.random.default_rng(0).choice(z.shape[0], n_points,
                                              replace=False)]
    z = z - z.mean(0)
    _, _, vt = np.linalg.svd(z, full_matrices=False)
    pts = z @ vt[:3].T
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2, alpha=0.5)
    ax.set_title("latent PCA")
    return fig


def power_to_db(spec: np.ndarray, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    """Power spectrogram -> dB, floored ``top_db`` below its peak."""
    log_spec = 10.0 * np.log10(np.maximum(amin, np.asarray(spec)))
    return np.maximum(log_spec, log_spec.max() - top_db)


def _mel_filterbank(fs: int, n_fft: int, n_mels: int) -> np.ndarray:
    """HTK-scale, slaney-normalized mel filterbank (n_mels, n_fft//2+1)."""
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)  # noqa
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)  # noqa
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, fs / 2, n_freqs)
    mel_pts = mel2hz(np.linspace(hz2mel(0.0), hz2mel(fs / 2), n_mels + 2))
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area norm
    return fb


def mel_spectrogram(waveform: np.ndarray, power: float = 2.0,
                    fs: int = 8000, db: bool = False, n_fft: int = 1024,
                    n_mels: int = 128) -> np.ndarray:
    """Mel spectrogram (n_mels, frames) of a mono waveform, hop n_fft // 2;
    in dB with ``db``."""
    spec = _abs_stft(waveform, n_fft, n_fft // 2)
    mel = _mel_filterbank(fs, n_fft, n_mels) @ (spec ** power)
    return power_to_db(mel) if db else mel


def audio_spectrogram_image(waveform: np.ndarray, power: float = 2.0,
                            fs: int = 8000, n_fft: int = 1024,
                            n_mels: int = 128,
                            title: str = "MelSpectrogram"):
    """Mel-spectrogram figure of a waveform, in dB."""
    plt = _mpl()
    mel = mel_spectrogram(waveform, power=power, fs=fs, n_fft=n_fft,
                          n_mels=n_mels)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(power_to_db(mel), origin="lower", aspect="auto",
                   cmap="magma")
    ax.set_ylabel("mel bins (log freq)")
    ax.set_xlabel("frame")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def tokens_spectrogram_image(tokens: np.ndarray, title: str = "Embeddings",
                             symmetric: bool = True,
                             mark_batches: bool = False,
                             cmap: str = "coolwarm"):
    """Embeddings (B, D, T) over time as a heatmap, the batches unrolled
    along the time axis."""
    plt = _mpl()
    z = np.asarray(tokens)
    b, d, n = z.shape
    emb = z.transpose(0, 2, 1).reshape(b * n, d)
    vmax = np.abs(emb).max() if symmetric else None
    vmin = -vmax if symmetric else None
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(emb.T, origin="lower", aspect="auto",
                   interpolation="none", cmap=cmap, vmin=vmin, vmax=vmax)
    if symmetric:
        ax.set_title(f"{title}\nmin={emb.min():0.4g}, max={emb.max():0.4g}")
    else:
        ax.set_title(title)
    ax.set_ylabel("index")
    ax.set_xlabel("time frame (samples, in batches)")
    if mark_batches:
        ax.vlines(np.arange(b) * n, -10, d + 10, color="black",
                  linestyle="dashed", linewidth=1)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def sde_marginal_evolution_figure(sde, x0: np.ndarray, mix: np.ndarray,
                                  n_t: int = 6, seed: int = 0):
    """A draw of the forward SDE's marginal at ``n_t`` times from 1e-3 to
    T: the first 200 samples of item 0's first source. One standard
    normal draw, from a CPU generator seeded with ``seed``, serves every
    time."""
    plt = _mpl()
    ts = np.linspace(1e-3, sde.T, n_t)
    fig, axes = plt.subplots(1, n_t, figsize=(2.2 * n_t, 2.5), sharey=True)
    x0_t = torch.from_numpy(np.asarray(x0, np.float32))
    mix_t = torch.from_numpy(np.asarray(mix, np.float32))
    z = torch.randn(x0_t.shape,
                    generator=torch.Generator().manual_seed(seed))
    for ax, t in zip(axes, ts):
        tv = torch.full((x0_t.shape[0],), float(t))
        mean, std = sde.marginal_prob(x0_t, tv, mix_t)
        xt = (mean + sde.mult_std(std, z)).numpy()
        ax.plot(xt[0, 0, :200], lw=0.5)
        ax.set_title(f"t={t:.2f}")
    fig.tight_layout()
    return fig
