"""Separation / enhancement metrics: SI-SDR/SI-SIR/SI-SAR (BSS eval),
STOI/ESTOI, PESQ (optional).

The port's own copy of ditsep_tpu/eval/metrics.py (numpy and scipy, the
same arithmetic). It replaces the reference's external metric stack —
fast_bss_eval (reference: src/evaluate_mp.py:171-189), pystoi and pesq
(src/evaluate_mp.py:29-31) — none of which is a dependency here.

* SI-SDR/SIR/SAR follow the scale-invariant BSS eval definitions
  (Le Roux et al. 2019) with brute-force permutation resolution, matching
  fast_bss_eval.si_bss_eval_sources semantics.
* STOI/ESTOI implemented from Taal et al. 2011 / Jensen & Taal 2016
  (the pystoi algorithm): 10 kHz resample, silent-frame removal,
  third-octave bands, 384 ms segments.
* PESQ (ITU-T P.862) uses the optional `pesq` package when present and
  otherwise the in-repo numpy implementation (pesq_p862.py).

All metrics are host-side numpy (they run on CPU threads while the card
samples the next batch).
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np


# ------------------------------------------------------------- BSS eval --
def _si_bss_project(est: np.ndarray, refs: np.ndarray,
                    eps: float = 1e-10):
    """Project est onto span(refs): returns (p_s, e_artif), which depend
    only on the estimate -- hoisted out of the per-reference loop (the
    Gram solve would otherwise run n^2 instead of n times)."""
    g = refs @ refs.T  # (n, n) Gram
    d = refs @ est     # (n,)
    try:
        c = np.linalg.solve(g + eps * np.eye(g.shape[0]), d)
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(g, d, rcond=None)[0]
    p_s = c @ refs
    return p_s, est - p_s


def _db(num: float, den: float, eps: float = 1e-10) -> float:
    return 10.0 * np.log10(max(num, eps) / max(den, eps))


def si_bss_eval_sources(
    ref: np.ndarray, est: np.ndarray, zero_mean: bool = False,
    clamp_db: float = 100.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scale-invariant SDR/SIR/SAR with optimal permutation.

    Args: ref, est (n_src, T).
    Returns (sdr, sir, sar, perm), each (n_src,), following the
    fast_bss_eval contract exactly (reference: src/evaluate_mp.py:176):
    metrics are ordered BY REFERENCE and ``est[perm]`` aligns to ``ref``
    (perm[j] = index of the estimate matching reference j), so
    per-source lists in results JSON diff directly against the
    reference's artifacts.

    ``zero_mean`` / ``clamp_db`` mirror fast_bss_eval's arguments AND
    defaults as the reference harness calls them
    (src/evaluate_mp.py:173-175: zero_mean=False, clamp_db=100): means
    are NOT subtracted unless asked, and each metric is clamped to
    [-clamp_db, clamp_db].
    """
    n = ref.shape[0]
    if zero_mean:
        ref = ref - ref.mean(axis=-1, keepdims=True)
        est = est - est.mean(axis=-1, keepdims=True)

    sdr_mat = np.zeros((n, n))  # [est i, ref j]
    sir_mat = np.zeros((n, n))
    sar_mat = np.zeros((n, n))
    for i in range(n):
        p_s, e_a = _si_bss_project(est[i], ref)
        for j in range(n):
            sref = ref[j]
            s_t = (est[i] @ sref) / max(sref @ sref, 1e-10) * sref
            e_i = p_s - s_t
            sdr_mat[i, j] = _db(s_t @ s_t, (e_i + e_a) @ (e_i + e_a))
            sir_mat[i, j] = _db(s_t @ s_t, e_i @ e_i)
            sar_mat[i, j] = _db((s_t + e_i) @ (s_t + e_i), e_a @ e_a)
    best, best_perm = -np.inf, tuple(range(n))
    for p in itertools.permutations(range(n)):
        v = np.mean([sdr_mat[i, p[i]] for i in range(n)])
        if v > best:
            best, best_perm = v, p
    # best_perm[i] = ref matched to est i; invert to the fast_bss_eval
    # orientation (perm[j] = est matched to ref j, metrics ref-ordered)
    inv = np.argsort(np.asarray(best_perm))
    cols = np.arange(n)
    clip = lambda m: np.clip(m[inv, cols], -clamp_db, clamp_db)
    return clip(sdr_mat), clip(sir_mat), clip(sar_mat), inv


# ----------------------------------------------------------------- STOI --
_STOI_FS = 10000
_STOI_NFRAME = 256
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30  # frames per segment (384 ms)
_STOI_BETA = -15.0
_STOI_DYN_RANGE = 40.0


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin(np.square(f - lo[i]))
        hi_i = np.argmin(np.square(f - hi[i]))
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _stoi_frames(x: np.ndarray, nframe: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - nframe)) // hop
    w = np.hanning(nframe + 2)[1:-1]
    out = np.stack([x[i * hop:i * hop + nframe] * w for i in range(n)])
    return out


def _remove_silent_frames(x, y, dyn_range, nframe, hop):
    w = np.hanning(nframe + 2)[1:-1]
    n = 1 + max(0, (len(x) - nframe)) // hop
    frames_x = np.stack([x[i * hop:i * hop + nframe] * w for i in range(n)])
    energies = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + 1e-20)
    mask = energies > (np.max(energies) - dyn_range)
    frames_y = np.stack([y[i * hop:i * hop + nframe] * w for i in range(n)])
    fx, fy = frames_x[mask], frames_y[mask]
    if len(fx) == 0:
        return x, y
    # overlap-add reconstruction
    t = (len(fx) - 1) * hop + nframe
    xs = np.zeros(t)
    ys = np.zeros(t)
    norm = np.zeros(t)
    for i in range(len(fx)):
        sl = slice(i * hop, i * hop + nframe)
        xs[sl] += fx[i]
        ys[sl] += fy[i]
        norm[sl] += w ** 2
    norm = np.where(norm > 1e-8, norm, 1.0)
    return xs / norm, ys / norm


def stoi(clean: np.ndarray, degraded: np.ndarray, fs: int,
         extended: bool = True) -> float:
    """(E)STOI intelligibility in ~[0, 1]."""
    from scipy.signal import resample_poly

    x = np.asarray(clean, np.float64).reshape(-1)
    y = np.asarray(degraded, np.float64).reshape(-1)
    if fs != _STOI_FS:
        g = np.gcd(fs, _STOI_FS)
        x = resample_poly(x, _STOI_FS // g, fs // g)
        y = resample_poly(y, _STOI_FS // g, fs // g)
    hop = _STOI_NFRAME // 2
    if min(len(x), len(y)) < _STOI_NFRAME:
        return float("nan")  # shorter than one frame: guard BEFORE
        # framing (the windowing would raise a broadcast error)
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_NFRAME, hop)
    if len(x) < _STOI_NFRAME:
        return float("nan")
    fx = _stoi_frames(x, _STOI_NFRAME, hop)
    fy = _stoi_frames(y, _STOI_NFRAME, hop)
    spec_x = np.abs(np.fft.rfft(fx, _STOI_NFFT, axis=1)) ** 2
    spec_y = np.abs(np.fft.rfft(fy, _STOI_NFFT, axis=1)) ** 2
    obm = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    bx = np.sqrt(spec_x @ obm.T).T  # (J, T)
    by = np.sqrt(spec_y @ obm.T).T
    n_seg = bx.shape[1] - _STOI_N + 1
    if n_seg <= 0:
        return float("nan")
    eps = 1e-15
    if extended:
        vals = []
        for m in range(n_seg):
            xs = bx[:, m:m + _STOI_N]
            ys = by[:, m:m + _STOI_N]
            # row (band) normalization over time
            xs = xs - xs.mean(axis=1, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=1, keepdims=True) + eps)
            ys = ys - ys.mean(axis=1, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=1, keepdims=True) + eps)
            # column (time) normalization over bands
            xs = xs - xs.mean(axis=0, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=0, keepdims=True) + eps)
            ys = ys - ys.mean(axis=0, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=0, keepdims=True) + eps)
            vals.append(np.sum(xs * ys) / _STOI_N)
        return float(np.mean(vals))
    # classic STOI with clipping
    c = 10.0 ** (-_STOI_BETA / 20.0)
    vals = []
    for m in range(n_seg):
        xs = bx[:, m:m + _STOI_N]
        ys = by[:, m:m + _STOI_N]
        alpha = (np.linalg.norm(xs, axis=1, keepdims=True)
                 / (np.linalg.norm(ys, axis=1, keepdims=True) + eps))
        ys_c = np.minimum(ys * alpha, xs * (1 + c))
        xs_n = xs - xs.mean(axis=1, keepdims=True)
        ys_n = ys_c - ys_c.mean(axis=1, keepdims=True)
        corr = np.sum(xs_n * ys_n, axis=1) / (
            np.linalg.norm(xs_n, axis=1) * np.linalg.norm(ys_n, axis=1)
            + eps)
        vals.append(np.mean(corr))
    return float(np.mean(vals))


# ----------------------------------------------------------------- PESQ --
_PESQ_FALLBACK_WARNED = False
_PESQ_ERROR_WARNED = False


def pesq_impl() -> str:
    """Which PESQ backend `pesq_metric` will use: "itu" for the
    ITU-wrapping `pesq` package (bit-exact with the reference,
    src/evaluate_mp.py:29) or "p862_numpy" for the in-repo
    implementation. Numbers from the two backends are NOT directly
    comparable; eval harnesses record this field alongside results."""
    try:
        import pesq  # noqa: F401
        return "itu"
    except ImportError:
        return "p862_numpy"


def pesq_metric(ref: np.ndarray, est: np.ndarray, fs: int,
                mode: str = "nb") -> float:
    """ITU-T P.862 PESQ (MOS-LQO). Uses the ITU-wrapping `pesq` package
    when installed; otherwise falls back to the in-repo numpy
    implementation (ditsep_tpu_torch.eval.pesq_p862), which follows the P.862
    algorithm chain and is calibrated on synthetic pairs. Warns once on
    fallback so parity comparisons aren't made across backends
    unknowingly; the backend id is available via `pesq_impl()`."""
    global _PESQ_FALLBACK_WARNED
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    try:
        from pesq import pesq as _pesq
    except ImportError:
        from ditsep_tpu_torch.eval.pesq_p862 import pesq as _pesq
        if not _PESQ_FALLBACK_WARNED:
            _PESQ_FALLBACK_WARNED = True
            import warnings
            warnings.warn(
                "pesq package not installed; using the in-repo P.862 "
                "approximation (pesq_impl='p862_numpy'). Scores are not "
                "directly comparable to ITU-PESQ numbers.", stacklevel=2)
    try:
        return float(_pesq(fs, ref, est, mode))
    except Exception as e:
        # NaN is the documented degraded result, but never silently:
        # a whole run of NaN composites otherwise looks like data, not
        # like the unsupported-fs / implementation error it is
        global _PESQ_ERROR_WARNED
        if not _PESQ_ERROR_WARNED:
            _PESQ_ERROR_WARNED = True
            import warnings
            warnings.warn(f"pesq failed ({e!r}); returning NaN (this "
                          "warning prints once)", stacklevel=2)
        return float("nan")


def compute_metrics(est: np.ndarray, target: np.ndarray,
                    fs: int = 8000) -> Dict[str, object]:
    """Per-utterance metric dict matching the reference's schema
    (reference: src/evaluate_mp.py:171-189 and the shipped
    results/.../librimix_test.json artifacts): si_sdr/si_sir/si_sar
    AND pesq/stoi are all PER-SOURCE lists (reference-ordered,
    permutation-aligned) — the reference loops pesq/stoi over sources
    (evaluate_mp.py:183-187), so artifact diffs need per-source values.
    si_bss_eval_sources is called with the reference harness's exact
    arguments (zero_mean=False, clamp_db=100)."""
    sdr, sir, sar, perm = si_bss_eval_sources(
        target, est, zero_mean=False, clamp_db=100.0)
    # fast_bss_eval orientation: est[perm] aligns to target
    aligned = est[np.asarray(perm)]
    pesq_vals = [pesq_metric(target[j], aligned[j], fs)
                 for j in range(target.shape[0])]
    stoi_vals = [stoi(target[j], aligned[j], fs, extended=True)
                 for j in range(target.shape[0])]
    return {
        "si_sdr": [float(v) for v in sdr],
        "si_sir": [float(v) for v in sir],
        "si_sar": [float(v) for v in sar],
        "perm": [int(v) for v in perm],
        "pesq": [float(v) for v in pesq_vals],
        "pesq_impl": pesq_impl(),
        "stoi": [float(v) for v in stoi_vals],
    }
