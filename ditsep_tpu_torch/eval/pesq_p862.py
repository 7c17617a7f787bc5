"""In-repo PESQ (ITU-T P.862) — host-side numpy implementation (the
port's own copy of ditsep_tpu/eval/pesq_p862.py, unchanged in its
arithmetic).

The reference evaluates every utterance with the ``pesq`` PyPI package
(reference: src/evaluate_mp.py:171-189, src/models/diffsep/losses.py:29-56)
and its composite CSIG/CBAK/COVL metrics are affine functions of PESQ
(src/evaluate/evaluate_covl.py:18-56).  That package (a wrapper around the
ITU C code) is not a dependency of this project, so this module
implements the P.862 algorithm chain directly from the standard:

  1. level alignment to a fixed listening level (average speech-band
     power of 1e7 in internal units),
  2. the standard IRS-receive input filter (narrowband mode; P.862.2
     wideband mode uses a flat high-pass instead), applied in the FFT
     domain as a piecewise-linear dB characteristic,
  3. envelope-based time alignment (cross-correlation of frame
     log-energy, then sample-level refinement),
  4. the psychoacoustic model: 32 ms Hann frames at 50% overlap ->
     power spectra -> Bark-warped pitch power densities -> per-band
     frequency compensation of the reference and per-frame gain
     compensation of the degraded signal -> Zwicker-law loudness,
  5. disturbance processing: masked (dead-zone) loudness difference,
     asymmetry weighting for additive distortions, L3/L1 frequency
     aggregation, L6-over-split-seconds / L2-over-time aggregation,
  6. the raw-PESQ combination 4.5 - 0.1*D - 0.0309*DA and the
     P.862.1 (nb) / P.862.2 (wb) logistic mappings to MOS-LQO.

Deviations from the letter of the standard (documented): the Bark band
edges and absolute-threshold table are generated analytically from the
Zwicker bark warping and the ISO-389/Terhardt threshold-in-quiet formula
rather than copied from the ITU tables (the ITU tables are not
redistributable; a band-edge
sensitivity bound is measured in tests/test_pesq.py), and the
band-4-neighbourhood Zwicker exponent correction is omitted (second
order: it perturbs only the 4 lowest bark bands' loudness exponent).
Utterance splitting (energy-VAD utterance spans, each aligned with its
own delay) and bad-interval re-alignment (high-disturbance frame runs
re-searched over local delays, keeping the smaller disturbance) ARE
implemented, following the standard's algorithm description.  Identical
signals score 4.55 (matching the ITU implementation's ceiling) and the
score is monotone in additive-noise SNR (tests/test_metrics.py).  When
the ITU-wrapping `pesq` package is importable, tests/test_pesq.py
cross-checks this implementation against it on synthetic pairs.
"""
from __future__ import annotations

import numpy as np

# --------------------------------------------------------------- filters --
# Standard IRS receive characteristic, piecewise-linear in (Hz, dB).
# P.862 applies this to both signals in narrowband mode.
_IRS_NB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0)])

# P.862.2 wideband input filter: flat with a high-pass below 100 Hz and a
# gentle rolloff near Nyquist.
_IRS_WB = np.array([
    (0, -500.0), (50, -500.0), (100, -3.0), (200, 0.0), (7000, 0.0),
    (7500, -3.0), (8000, -500.0)])

_TARGET_POWER = 1e7  # internal listening-level power after alignment


def _apply_fft_filter(x: np.ndarray, fs: int, table: np.ndarray
                      ) -> np.ndarray:
    """Filter the whole signal with a piecewise-linear dB magnitude
    characteristic (zero phase), the way the ITU code's apply_filter
    works on the full recording."""
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    gains_db = np.interp(freqs, table[:, 0], table[:, 1])
    spec *= 10.0 ** (gains_db / 20.0)
    return np.fft.irfft(spec, n)


def _band_power(x: np.ndarray, fs: int, lo: float = 325.0,
                hi: float = 3250.0) -> float:
    """Average power restricted to the speech band (level alignment)."""
    spec = np.abs(np.fft.rfft(x)) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    band = (freqs >= lo) & (freqs <= hi)
    # Parseval: sum|X|^2 / n^2 * 2 approximates time-domain mean power
    return 2.0 * np.sum(spec[band]) / (len(x) ** 2) + 1e-20


def _fix_power_level(x: np.ndarray, fs: int) -> np.ndarray:
    return x * np.sqrt(_TARGET_POWER / _band_power(x, fs))


# --------------------------------------------------------- time alignment --
def _align(ref: np.ndarray, deg: np.ndarray, fs: int) -> np.ndarray:
    """Globally align deg to ref: crude frame-energy correlation followed
    by a +-1 frame sample-level refinement. Returns shifted deg."""
    hop = fs // 250  # 4 ms envelope resolution
    n = min(len(ref), len(deg)) // hop * hop
    er = np.log1p(np.sum(ref[:n].reshape(-1, hop) ** 2, axis=1))
    ed = np.log1p(np.sum(deg[:n].reshape(-1, hop) ** 2, axis=1))
    er = er - er.mean()
    ed = ed - ed.mean()
    corr = np.correlate(er, ed, mode="full")
    lag_f = int(np.argmax(corr)) - (len(ed) - 1)
    delay = lag_f * hop
    # refine at sample resolution: full FFT cross-correlation, restricted
    # to +-0.25 s around the crude envelope estimate
    m = min(len(ref), len(deg))
    nfft = int(2 ** np.ceil(np.log2(2 * m)))
    xc = np.fft.irfft(np.fft.rfft(ref[:m], nfft)
                      * np.conj(np.fft.rfft(deg[:m], nfft)), nfft)
    lags = np.concatenate([np.arange(0, m), np.arange(-m + 1, 0)])
    vals = np.concatenate([xc[:m], xc[nfft - m + 1:]])
    win = fs // 4
    sel = np.abs(lags - delay) <= win
    d = int(lags[sel][np.argmax(vals[sel])])
    if d > 0:
        deg = np.concatenate([np.zeros(d), deg])
    elif d < 0:
        deg = deg[-d:]
    return deg


def _split_utterances(ref: np.ndarray, fs: int):
    """Energy-VAD utterance spans [(start, end) samples) on the reference
    (P.862's utterance splitting): 4 ms frame energies, active when above
    1/1000 of the peak frame energy; gaps < 200 ms merge; spans < 300 ms
    drop (absorbed by their neighbours' alignment)."""
    hop = fs // 250
    n = len(ref) // hop * hop
    if n == 0:
        return [(0, len(ref))]
    e = np.sum(ref[:n].reshape(-1, hop) ** 2, axis=1)
    thr = e.max() / 1e3 + 1e-20
    active = e > thr
    spans = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append([start, i])
            start = None
    if start is not None:
        spans.append([start, len(active)])
    if not spans:
        return [(0, len(ref))]
    merged = [spans[0]]
    for s, t in spans[1:]:
        if (s - merged[-1][1]) * hop < int(0.2 * fs):
            merged[-1][1] = t
        else:
            merged.append([s, t])
    min_len = int(0.3 * fs) // hop
    out = [(s * hop, t * hop) for s, t in merged if t - s >= min_len]
    return out or [(0, len(ref))]


def _utterance_align(ref: np.ndarray, deg: np.ndarray, fs: int
                     ) -> np.ndarray:
    """Per-utterance time alignment (P.862 utterance splitting): after the
    global alignment, each VAD utterance of the reference gets its own
    delay (cross-correlation within +-50 ms) and the degraded signal is
    re-assembled piecewise so time-warped recordings line up per
    utterance rather than only on average."""
    deg = _align(ref, deg, fs)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    out = deg.copy()
    win = fs // 20  # +-50 ms local search
    for s, t in _split_utterances(ref, fs):
        t = min(t, n)
        if t - s < fs // 8:
            continue
        r = ref[s:t]
        lo, hi = max(0, s - win), min(n, t + win)
        d = deg[lo:hi]
        if len(d) <= len(r):
            continue
        # c[q] = sum_m r[m] * d[m+q]; deg span [s+sigma, t+sigma) matches
        # ref span [s, t) at sigma = q - (s - lo)
        c = np.correlate(d, r, mode="valid")
        sigma = int(np.argmax(c)) - (s - lo)
        src_lo, src_hi = s + sigma, t + sigma
        if src_lo < 0 or src_hi > n:
            continue
        out[s:t] = deg[src_lo:src_hi]
    return out


# ----------------------------------------------------- psychoacoustics ----
def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker bark warping (the scale underlying the P.862 band table)."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _bark_inv(z: np.ndarray) -> np.ndarray:
    grid = np.linspace(0.0, 9000.0, 4096)
    return np.interp(z, _bark(grid), grid)


def _threshold_in_quiet_db(f: np.ndarray) -> np.ndarray:
    """Terhardt threshold-in-quiet (dB SPL), the analytic form of the
    absolute-threshold table in the standard."""
    k = np.maximum(f, 20.0) / 1000.0
    return (3.64 * k ** -0.8
            - 6.5 * np.exp(-0.6 * (k - 3.3) ** 2)
            + 1e-3 * k ** 4)


# Band-edge perturbation hook (bark-scale fraction). Used by the
# sensitivity test to bound the effect of the analytic-vs-ITU band-table
# deviation; 0.0 in production.
_EDGE_PERTURB = 0.0


class _PesqBands:
    """Bark band layout + absolute thresholds for one (fs, mode)."""

    def __init__(self, fs: int, mode: str):
        self.fs = fs
        self.frame = int(0.032 * fs)           # 32 ms
        self.hop = self.frame // 2
        self.nfft = self.frame
        f_hi = 3500.0 if mode == "nb" else 7000.0
        n_bands = 42 if mode == "nb" else 49
        edges_bark = np.linspace(_bark(100.0), _bark(f_hi), n_bands + 1)
        if _EDGE_PERTURB:
            rng = np.random.default_rng(0)
            width = edges_bark[1] - edges_bark[0]
            edges_bark = edges_bark + width * _EDGE_PERTURB * rng.uniform(
                -1.0, 1.0, edges_bark.shape)
            edges_bark.sort()
        edges_hz = _bark_inv(edges_bark)
        freqs = np.fft.rfftfreq(self.nfft, 1.0 / fs)
        self.band_of_bin = np.digitize(freqs, edges_hz) - 1
        self.valid = (self.band_of_bin >= 0) & (self.band_of_bin < n_bands)
        self.n_bands = n_bands
        self.centre_hz = 0.5 * (edges_hz[:-1] + edges_hz[1:])
        self.width_bark = np.diff(edges_bark)
        # Absolute threshold in internal power units. The calibration
        # constant maps the Terhardt dB curve into the level-aligned
        # internal scale; chosen so an actively-spoken level-aligned
        # signal sits ~70-80 dB above threshold at 1 kHz, mirroring the
        # listening level the ITU tables assume.
        thr_db = _threshold_in_quiet_db(self.centre_hz)
        self.abs_thresh = 10.0 ** ((thr_db + 18.0) / 10.0)
        # loudness scaling (Sl); the power calibration folds into the raw
        # periodogram scale + the threshold offset above
        self.sl = 1.866055e-1

    def pitch_power(self, frames_pow: np.ndarray) -> np.ndarray:
        """(T, nfft//2+1) power spectra -> (T, n_bands) pitch power
        densities (mean power per band, ITU internal scale)."""
        t = frames_pow.shape[0]
        out = np.zeros((t, self.n_bands))
        idx = self.band_of_bin[self.valid]
        np.add.at(out.T, idx, frames_pow[:, self.valid].T)
        counts = np.bincount(idx, minlength=self.n_bands).astype(np.float64)
        counts = np.maximum(counts, 1.0)
        return out / counts


def _frames_power(x: np.ndarray, bands: _PesqBands) -> np.ndarray:
    n = bands.frame
    hop = bands.hop
    t = max(0, (len(x) - n) // hop + 1)
    if t == 0:
        return np.zeros((0, n // 2 + 1))
    w = np.hanning(n)
    idx = np.arange(n)[None, :] + hop * np.arange(t)[:, None]
    fr = x[idx] * w
    # raw periodogram, ITU internal scale (no window normalisation: the
    # level alignment to 1e7 band power fixes the absolute calibration)
    return np.abs(np.fft.rfft(fr, axis=1)) ** 2


def _loudness(pp: np.ndarray, bands: _PesqBands) -> np.ndarray:
    """Zwicker-law loudness density (T, n_bands)."""
    p0 = bands.abs_thresh[None, :]
    zw = 0.23
    s = (bands.sl * (p0 / 0.5) ** zw
         * ((0.5 + 0.5 * pp / p0) ** zw - 1.0))
    return np.maximum(s, 0.0)


def _lp_norm(x: np.ndarray, w: np.ndarray, p: float) -> np.ndarray:
    """ITU pseudo-Lp over the last axis with band weights w."""
    return (np.sum((np.abs(x) * w) ** p, axis=-1) / np.sum(w)) ** (1.0 / p)


def pesq_raw(ref: np.ndarray, deg: np.ndarray, fs: int,
             mode: str = "nb", bad_interval: bool = True) -> float:
    """Raw P.862 PESQ score (~[-0.5, 4.5]). ``bad_interval=False``
    disables the bad-interval re-alignment stage (testing only)."""
    ref = np.asarray(ref, np.float64).reshape(-1).copy()
    deg = np.asarray(deg, np.float64).reshape(-1).copy()
    if fs not in (8000, 16000):
        raise ValueError(f"PESQ supports 8/16 kHz, got {fs}")
    if mode == "wb" and fs == 8000:
        raise ValueError("wideband PESQ needs 16 kHz input")
    if min(len(ref), len(deg)) < int(0.25 * fs):
        return float("nan")

    # 1. level alignment + input filtering
    ref = _fix_power_level(ref, fs)
    deg = _fix_power_level(deg, fs)
    table = _IRS_NB if mode == "nb" else _IRS_WB
    ref = _apply_fft_filter(ref, fs, table)
    deg = _apply_fft_filter(deg, fs, table)

    # 2. time alignment: global, then per-utterance (P.862 utterance
    # splitting -- each VAD utterance gets its own delay)
    deg = _utterance_align(ref, deg, fs)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    # 3. bark pitch power densities
    bands = _PesqBands(fs, mode)
    pr = bands.pitch_power(_frames_power(ref, bands))
    pd = bands.pitch_power(_frames_power(deg, bands))
    t = min(pr.shape[0], pd.shape[0])
    if t < 4:
        return float("nan")
    pr, pd = pr[:t], pd[:t]

    total_audible_ref = np.sum(
        np.where(pr > bands.abs_thresh[None, :], pr, 0.0), axis=1)
    active = total_audible_ref > 1e7  # speech-active frames

    # 4a. frequency compensation of the reference (linear-filter equalise)
    num = np.sum(pd[active], axis=0) + 1e3
    den = np.sum(pr[active], axis=0) + 1e3
    band_ratio = np.clip(num / den, 0.01, 100.0)
    pr_eq = pr * band_ratio[None, :]

    # 4b. per-frame gain compensation of the degraded (slowly varying gain)
    aud_r = np.sum(np.where(pr_eq > bands.abs_thresh, pr_eq, 0.0), axis=1)
    aud_d = np.sum(np.where(pd > bands.abs_thresh, pd, 0.0), axis=1)
    ratio = (aud_r + 5e3) / (aud_d + 5e3)
    gain = np.empty(t)
    h = 1.0
    for i in range(t):
        h = 0.8 * h + 0.2 * np.clip(ratio[i], 3e-4, 5.0)
        gain[i] = h
    pd_eq = pd * gain[:, None]

    # 5. loudness + disturbance
    lr = _loudness(pr_eq, bands)
    weight = ((total_audible_ref + 1e5) / 1e7) ** 0.04

    def disturbance(pd_rows, rows):
        """Weighted (uncapped) frame disturbances for degraded pitch
        powers `pd_rows` against reference frames `rows`."""
        ld = _loudness(pd_rows, bands)
        lr_r = lr[rows]
        d = ld - lr_r
        m = 0.25 * np.minimum(lr_r, ld)
        d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)
        # asymmetry: additive distortions weigh more than omissions
        hfac = ((pd_rows + 50.0) / (pr_eq[rows] + 50.0)) ** 1.2
        hfac = np.where(hfac < 3.0, 0.0, np.minimum(hfac, 12.0))
        da = d * hfac
        w = bands.width_bark
        df = _lp_norm(d, w, 3.0) / weight[rows]
        daf = (np.sum(np.abs(da) * w, axis=1) / np.sum(w)) / weight[rows]
        return df, daf

    all_rows = np.arange(t)
    d_frame, da_frame = disturbance(pd_eq, all_rows)

    # 5b. bad-interval re-alignment (P.862): runs of frames whose
    # symmetric disturbance exceeds the cap threshold are re-searched
    # over local delays of the degraded signal (same equalisations);
    # each interval keeps its minimal disturbance.
    BAD = 45.0
    bad = (d_frame > BAD) if bad_interval else np.zeros(t, bool)
    if bad.any():
        hop, frame = bands.hop, bands.frame
        deltas = np.unique(np.linspace(
            -fs // 40, fs // 40, 17).astype(int))  # +-25 ms search
        runs = []
        f0 = None
        for i, b in enumerate(bad):
            if b and f0 is None:
                f0 = i
            elif not b and f0 is not None:
                runs.append((f0, i))
                f0 = None
        if f0 is not None:
            runs.append((f0, t))
        for f0, f1 in runs:
            f0e, f1e = max(0, f0 - 1), min(t, f1 + 1)  # widen by 1 frame
            rows = np.arange(f0e, f1e)
            best = float(np.sum(d_frame[rows]))
            best_df, best_daf = d_frame[rows], da_frame[rows]
            lo = f0e * hop
            hi = (f1e - 1) * hop + frame
            for dl in deltas:
                if dl == 0 or lo + dl < 0 or hi + dl > len(deg):
                    continue
                seg = deg[lo + dl:hi + dl]
                pd_i = bands.pitch_power(_frames_power(seg, bands))
                if pd_i.shape[0] < len(rows):
                    continue
                pd_i = pd_i[:len(rows)] * gain[rows, None]
                df_i, daf_i = disturbance(pd_i, rows)
                tot = float(np.sum(df_i))
                if tot < best:
                    best, best_df, best_daf = tot, df_i, daf_i
            d_frame[rows] = best_df
            da_frame[rows] = best_daf

    d_frame = np.minimum(d_frame, 45.0)
    da_frame = np.minimum(da_frame, 45.0)

    # 6. L6 over split-second (20-frame) intervals, L2 over time
    def aggregate(df: np.ndarray) -> float:
        win = 20
        if len(df) <= win:
            chunks = df[None, :]
        else:
            starts = np.arange(0, len(df) - win + 1, win // 2)
            if starts[-1] + win < len(df):
                # right-aligned tail window so trailing frames (up to 9)
                # still enter the aggregation — distortion confined to
                # the end of an utterance must not vanish (the ITU Lpq
                # includes a clipped partial last interval)
                starts = np.append(starts, len(df) - win)
            chunks = np.stack([df[s:s + win] for s in starts])
        l6 = (np.mean(chunks ** 6.0, axis=1)) ** (1.0 / 6.0)
        return float(np.sqrt(np.mean(l6 ** 2)))

    d_sym = aggregate(d_frame)
    d_asym = aggregate(da_frame)
    return 4.5 - 0.1 * d_sym - 0.0309 * d_asym


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray,
         mode: str = "nb") -> float:
    """MOS-LQO PESQ with the same call signature as the `pesq` package
    (reference call site: src/evaluate_mp.py:186). Narrowband applies the
    P.862.1 mapping, wideband the P.862.2 mapping."""
    raw = pesq_raw(ref, deg, fs, mode)
    if not np.isfinite(raw):
        return float("nan")
    if mode == "wb":
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
