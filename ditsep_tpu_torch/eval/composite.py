"""Composite speech-enhancement metrics: CSIG / CBAK / COVL.

Implements the Hu & Loizou (2008) composite objective measures used by the
reference's enhancement evaluation (reference: src/evaluate/
evaluate_covl.py:18-474, itself a port of facebookresearch/denoiser):
segmental SNR, weighted spectral slope (WSS, Klatt 1982 critical bands),
log-likelihood ratio (LLR via LPC/Levinson-Durbin), combined with PESQ by
the published regression weights. Host-side numpy (the port's own copy
of ditsep_tpu/eval/composite.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ditsep_tpu_torch.eval.metrics import pesq_metric

# Klatt (1982) critical-band center frequencies / bandwidths (Hz), the
# standard 25-band table used by the WSS measure.
_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457,
    199.776, 217.153, 235.631, 255.255, 276.072, 298.126, 321.465,
    346.136])


def _frames(x: np.ndarray, winlength: int, skiprate: int) -> np.ndarray:
    n = int(len(x) / skiprate - winlength / skiprate)
    t = np.linspace(1, winlength, winlength) / (winlength + 1)
    window = 0.5 * (1 - np.cos(2 * np.pi * t))
    out = np.stack([x[i * skiprate: i * skiprate + winlength] * window
                    for i in range(n)])
    return out


def ssnr(ref: np.ndarray, deg: np.ndarray, fs: int = 16000,
         eps: float = 1e-10) -> Tuple[float, np.ndarray]:
    """Overall SNR and per-frame segmental SNR clipped to [-10, 35] dB."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    overall = 10 * np.log10(
        np.sum(ref ** 2) / max(np.sum((ref - deg) ** 2), eps) + eps)
    winlength = int(round(30 * fs / 1000))
    skiprate = winlength // 4
    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    sig = np.sum(fr ** 2, axis=1)
    noise = np.sum((fr - fd) ** 2, axis=1)
    seg = 10 * np.log10(sig / np.maximum(noise, eps) + eps)
    return float(overall), np.clip(seg, -10.0, 35.0)


def _lpc(frame: np.ndarray, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin LPC; returns (a (order+1,), autocorrelation R)."""
    r = np.array([np.dot(frame[: len(frame) - k], frame[k:])
                  for k in range(order + 1)])
    a = np.zeros(order + 1)
    a[0] = 1.0
    e = r[0]
    if e <= 0:
        return a, r
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[i - 1:0:-1])
        k = -acc / e
        a_new = a.copy()
        a_new[i] = k
        a_new[1:i] += k * a[1:i][::-1]
        a = a_new
        e *= (1 - k * k)
        if e <= 0:
            break
    return a, r


def llr(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> np.ndarray:
    """Per-frame log-likelihood ratio distances."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    winlength = int(round(30 * fs / 1000))
    skiprate = winlength // 4
    order = 10 if fs < 10000 else 16
    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    out = []
    for i in range(fr.shape[0]):
        a_ref, r_ref = _lpc(fr[i], order)
        a_deg, _ = _lpc(fd[i], order)
        # Toeplitz quadratic forms via autocorrelation of coefficients
        def quad(a):
            acf = np.array([np.dot(a[: order + 1 - k], a[k:])
                            for k in range(order + 1)])
            return r_ref[0] * acf[0] + 2 * np.dot(r_ref[1:], acf[1:])

        num = quad(a_deg)
        den = quad(a_ref)
        out.append(np.log(max(num, 1e-10) / max(den, 1e-10)))
    return np.asarray(out)


def wss(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> np.ndarray:
    """Per-frame weighted spectral slope distances (Klatt 1982)."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    winlength = int(round(30 * fs / 1000))
    skiprate = winlength // 4
    max_freq = fs / 2
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_bands = 25
    kmax, klocmax = 20.0, 1.0

    # critical-band filter magnitudes on the FFT grid
    cf = _CENT_FREQ[:n_bands]
    bw = _BANDWIDTH[:n_bands]
    min_factor = np.exp(-30.0 / (2 * 2.303))
    filters = np.zeros((n_bands, n_fft // 2))
    for i in range(n_bands):
        f0 = cf[i] / max_freq * (n_fft / 2)
        bwi = bw[i] / max_freq * (n_fft / 2)
        # gain bw_min/bw_i in the Hz domain (reference:
        # evaluate_covl.py:243 norm_factor = log(bw_min) - log(bw_i));
        # the inverted/FFT-scaled form skews wide bands by (bw_i/bw_0)^2
        norm_factor = np.log(_BANDWIDTH[0]) - np.log(bw[i])
        j = np.arange(n_fft // 2)
        filters[i] = np.exp(-11 * ((j - np.floor(f0)) / bwi) ** 2
                            + norm_factor)
        filters[i][filters[i] < min_factor] = 0.0

    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    out = []
    for i in range(fr.shape[0]):
        sp_r = np.abs(np.fft.fft(fr[i], n_fft)[: n_fft // 2]) ** 2
        sp_d = np.abs(np.fft.fft(fd[i], n_fft)[: n_fft // 2]) ** 2
        eb_r = 10 * np.log10(np.maximum(filters @ sp_r, 1e-10))
        eb_d = 10 * np.log10(np.maximum(filters @ sp_d, 1e-10))
        sl_r = np.diff(eb_r)
        sl_d = np.diff(eb_d)
        # weights from peak proximity
        def weights(eb, sl):
            dbmax = np.max(eb)
            w = np.zeros(n_bands - 1)
            for k in range(n_bands - 1):
                if sl[k] > 0:
                    j = k
                    while j < n_bands - 1 and sl[j] > 0:
                        j += 1
                    peak = eb[j]
                else:
                    j = k
                    while j > 0 and sl[j - 1] <= 0:
                        j -= 1
                    peak = eb[j]
                wmax = kmax / (kmax + dbmax - eb[k])
                wlocmax = klocmax / (klocmax + peak - eb[k])
                w[k] = wmax * wlocmax
            return w

        w_r = weights(eb_r, sl_r)
        w_d = weights(eb_d, sl_d)
        w = (w_r + w_d) / 2
        out.append(float(np.sum(w * (sl_r - sl_d) ** 2) / np.sum(w)))
    return np.asarray(out)


def _trim_mos(v: float) -> float:
    return float(min(max(v, 1.0), 5.0))


def eval_composite(ref: np.ndarray, deg: np.ndarray, fs: int = 16000,
                   alpha: float = 0.95) -> Dict[str, float]:
    """CSIG/CBAK/COVL (reference: src/evaluate/evaluate_covl.py:18-56).
    PESQ enters through `pesq_metric` (ITU package when installed, else
    the in-repo P.862 implementation); a failed PESQ (e.g. unsupported
    fs) propagates NaN into the composites with a one-time warning."""
    ref = np.asarray(ref).reshape(-1)
    deg = np.asarray(deg).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    # the framed measures need at least one full analysis window plus a
    # hop (30 ms win, 7.5 ms skip); shorter clips get NaN rather than a
    # np.stack-of-nothing crash
    min_len = int(round(30 * fs / 1000)) + int(round(30 * fs / 1000)) // 4
    if n < min_len:
        nan = float("nan")
        return {"csig": nan, "cbak": nan, "covl": nan, "wss": nan,
                "llr": nan, "ssnr": nan, "pesq": nan}

    wss_vec = np.sort(wss(ref, deg, fs))
    wss_dist = float(np.mean(wss_vec[: int(round(len(wss_vec) * alpha))]))
    llr_vec = np.sort(llr(ref, deg, fs))
    llr_mean = float(np.mean(llr_vec[: int(round(len(llr_vec) * alpha))]))
    _, seg = ssnr(ref, deg, fs)
    seg_snr = float(np.mean(seg))
    pesq_raw = pesq_metric(ref, deg, fs, mode="wb" if fs >= 16000 else "nb")

    csig = 3.093 - 1.029 * llr_mean + 0.603 * pesq_raw - 0.009 * wss_dist
    cbak = 1.634 + 0.478 * pesq_raw - 0.007 * wss_dist + 0.063 * seg_snr
    covl = 1.594 + 0.805 * pesq_raw - 0.512 * llr_mean - 0.007 * wss_dist
    return {"csig": _trim_mos(csig), "cbak": _trim_mos(cbak),
            "covl": _trim_mos(covl), "wss": wss_dist, "llr": llr_mean,
            "ssnr": seg_snr, "pesq": pesq_raw}
