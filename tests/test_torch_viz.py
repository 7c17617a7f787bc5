"""viz.py against the JAX package's: each figure's axes, labels, titles
and extents, the |STFT| behind each image (1e-5 of max|ref|; the two
STFTs differ by about that, so dB values near zero are not compared), the
mel filterbank, mel spectrogram and dB conversion (1e-6 relative), the PCA
point cloud, and spectrogram_preview; then ``evaluate_dataset``'s media
(``save_samples`` / ``save_figures``): JAX's file names, and a failing
figure printed and counted while the run goes on."""
import numpy as np
import pytest

pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ditsep_tpu import viz as jviz  # noqa: E402
from ditsep_tpu.data import SyntheticMixDataset as JaxSynthetic  # noqa: E402
from ditsep_tpu.eval import evaluate as jax_evaluate  # noqa: E402
from ditsep_tpu.sdes import MixSDE as JaxMixSDE  # noqa: E402
from ditsep_tpu_torch import viz  # noqa: E402
from ditsep_tpu_torch.data import SyntheticMixDataset  # noqa: E402
from ditsep_tpu_torch.eval import evaluate  # noqa: E402
from ditsep_tpu_torch.interface.app import spectrogram_preview  # noqa: E402
from ditsep_tpu_torch.sdes import MixSDE  # noqa: E402
from test_torch_evaluate import _separator  # noqa: E402

RNG = np.random.default_rng(0)
MIX = (0.3 * RNG.standard_normal(2400)).astype(np.float32)
EST = (0.2 * RNG.standard_normal((2, 2400))).astype(np.float32)
TGT = (0.2 * RNG.standard_normal((2, 2400))).astype(np.float32)


def _layout(fig):
    """Every axes' labels, title, ticks and the extent and colormap of its
    images."""
    out = []
    for ax in fig.axes:
        out.append({
            "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "title": ax.get_title(), "xticks": len(ax.get_xticks()) == 0,
            "yticks": len(ax.get_yticks()) == 0,
            "images": [(tuple(np.round(im.get_extent(), 6)),
                        im.get_cmap().name, im.origin,
                        im.get_array().shape) for im in ax.images]})
    return out


def _magnitudes(fig):
    """The |STFT| behind each image (the images hold 20 log10(|S| +
    1e-8))."""
    return [10.0 ** (np.asarray(im.get_array(), np.float64) / 20.0) - 1e-8
            for ax in fig.axes for im in ax.images]


def _check_figures(got, want):
    try:
        assert _layout(got) == _layout(want)
        assert tuple(got.get_size_inches()) == tuple(want.get_size_inches())
        for g, w in zip(_magnitudes(got), _magnitudes(want)):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    finally:
        plt.close(got)
        plt.close(want)


@pytest.mark.parametrize("kw", [{}, {"fs": 16000, "title": "mix"},
                                {"n_fft": 254, "hop": 64}])
def test_spectrogram_image_matches_jax(kw):
    _check_figures(viz.spectrogram_image(MIX, **kw),
                   jviz.spectrogram_image(MIX, **kw))


@pytest.mark.parametrize("with_target", [True, False])
def test_separation_figure_matches_jax(with_target):
    tgt = TGT if with_target else None
    got = viz.separation_figure(MIX, EST, tgt)
    assert len(got.axes) == (5 if with_target else 3)
    _check_figures(got, jviz.separation_figure(MIX, EST, tgt))


def test_diffusion_evolution_figure_matches_jax():
    traj = (0.1 * RNG.standard_normal((9, 1, 2, 1500))).astype(np.float32)
    _check_figures(viz.diffusion_evolution_figure(traj, n_show=4, source=1),
                   jviz.diffusion_evolution_figure(traj, n_show=4, source=1))


def test_spectrogram_preview_is_the_spectrogram_image():
    _check_figures(spectrogram_preview(MIX.reshape(-1, 1)),
                   jviz.spectrogram_image(MIX))


@pytest.mark.parametrize("n", [2000, 50])
def test_latent_pca_point_cloud_matches_jax(n):
    lat = RNG.standard_normal((3, 8, 40)).astype(np.float32)
    got = viz.latent_pca_point_cloud(lat, n_points=n)
    want = jviz.latent_pca_point_cloud(lat, n_points=n)
    try:
        g = np.stack(got.axes[0].collections[0]._offsets3d, 1)
        w = np.stack(want.axes[0].collections[0]._offsets3d, 1)
        assert g.shape == w.shape == (min(n, 120), 3)
        np.testing.assert_array_equal(g, w)
        assert got.axes[0].get_title() == want.axes[0].get_title()
    finally:
        plt.close(got)
        plt.close(want)


def test_mel_filterbank_and_db_match_jax():
    for fs, n_fft, n_mels in ((8000, 1024, 128), (16000, 512, 40)):
        g = viz._mel_filterbank(fs, n_fft, n_mels)
        w = jviz._mel_filterbank(fs, n_fft, n_mels)
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    spec = RNG.random((16, 30)) ** 4
    np.testing.assert_allclose(viz.power_to_db(spec), jviz.power_to_db(spec),
                               rtol=1e-6)
    np.testing.assert_allclose(viz.power_to_db(spec, top_db=20.0),
                               jviz.power_to_db(spec, top_db=20.0),
                               rtol=1e-6)


@pytest.mark.parametrize("db", [False, True])
def test_mel_spectrogram_matches_jax(db):
    x = (0.3 * RNG.standard_normal(6000)).astype(np.float32)
    for power in (1.0, 2.0):
        g = viz.mel_spectrogram(x, power=power, db=db)
        w = jviz.mel_spectrogram(x, power=power, db=db)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


def test_audio_and_tokens_images_match_jax():
    x = (0.3 * RNG.standard_normal(6000)).astype(np.float32)
    got = viz.audio_spectrogram_image(x, title="t")
    want = jviz.audio_spectrogram_image(x, title="t")
    try:
        assert _layout(got) == _layout(want)
        g = np.asarray(got.axes[0].images[0].get_array())
        w = np.asarray(want.axes[0].images[0].get_array())
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    finally:
        plt.close(got)
        plt.close(want)
    tok = RNG.standard_normal((2, 6, 10)).astype(np.float32)
    for kw in ({}, {"symmetric": False, "mark_batches": True}):
        got = viz.tokens_spectrogram_image(tok, **kw)
        want = jviz.tokens_spectrogram_image(tok, **kw)
        try:
            assert _layout(got) == _layout(want)
            np.testing.assert_array_equal(got.axes[0].images[0].get_array(),
                                          want.axes[0].images[0].get_array())
            assert (len(got.axes[0].collections)
                    == len(want.axes[0].collections))
        finally:
            plt.close(got)
            plt.close(want)


def test_sde_marginal_evolution_figure_has_jax_layout():
    x0 = (0.1 * RNG.standard_normal((1, 2, 400))).astype(np.float32)
    mix = x0.sum(1, keepdims=True)
    got = viz.sde_marginal_evolution_figure(MixSDE(), x0, mix, n_t=4)
    want = jviz.sde_marginal_evolution_figure(JaxMixSDE(), jnp.asarray(x0),
                                              jnp.asarray(mix), n_t=4)
    try:
        assert _layout(got) == _layout(want)
        for g, w in zip(got.axes, want.axes):
            assert (g.lines[0].get_xydata().shape
                    == w.lines[0].get_xydata().shape == (200, 2))
            assert np.isfinite(g.lines[0].get_xydata()).all()
    finally:
        plt.close(got)
        plt.close(want)


def test_available_says_matplotlib_is_here():
    assert viz.available()


def _evaluate_media(tmp_path, save_samples, save_figures):
    """Both packages' evaluate_dataset with the same deterministic
    separator: the port's result and each side's media file names."""
    kw = dict(n_items=4, min_len_s=0.45, max_len_s=0.6, seed=2)
    port_fn, jax_fn = _separator([])
    common = dict(fs=8000, batch_size=2, frame_spec=(126, 32, 64), nfe=4,
                  split_name="synthetic_test", warmup=False,
                  save_samples=save_samples, save_figures=save_figures)
    res = evaluate.evaluate_dataset(port_fn, SyntheticMixDataset(**kw),
                                    out_dir=str(tmp_path / "port"),
                                    device="cpu", **common)
    jax_evaluate.evaluate_dataset(jax_fn, JaxSynthetic(**kw),
                                  out_dir=str(tmp_path / "jax"), **common)
    names = {side: sorted(p.name for p in (tmp_path / side /
                                           "synthetic_test_media").iterdir())
             for side in ("port", "jax")}
    return res, names


@pytest.mark.parametrize("samples,figures", [(1, 3), (2, 0), (0, 2)])
def test_evaluate_dataset_writes_jax_media_names(tmp_path, samples,
                                                 figures):
    res, names = _evaluate_media(tmp_path, samples, figures)
    assert names["port"] == names["jax"]
    assert sum(n.endswith(".pdf") for n in names["port"]) == figures
    assert sum(n.endswith(".wav") for n in names["port"]) == 2 * samples
    assert res["media_failures"] == 0


def test_a_failing_figure_is_counted(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no figure")

    monkeypatch.setattr(viz, "separation_figure", boom)
    res, names = _evaluate_media(tmp_path, 1, 2)
    assert res["media_failures"] == 2
    assert names["port"] == ["0000.enh0.wav", "0000.enh1.wav"]
    assert "the figure of item 1 failed" in capsys.readouterr().err
