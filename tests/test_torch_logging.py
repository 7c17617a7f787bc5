"""The port's MetricsLogger against the JAX package's: the audio summary's
WAV bytes, the scalars in both sinks, figures, the disabled logger, and
the guard that counts swallowed media failures."""
import json

import numpy as np
import pytest

from ditsep_tpu.utils.logging import MetricsLogger as JaxLogger
from ditsep_tpu_torch.utils.logging import MetricsLogger
from tb_events import read_events

pytest.importorskip("tensorboardX")


def _audio_cases():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(1000)).astype(np.float32)
    bad = x.copy()
    bad[[3, 50, 700]] = [np.nan, np.inf, -np.inf]
    return {"plain": x, "non_finite": bad, "silent": np.zeros(64, np.float32),
            "two_d": x.reshape(2, 500), "float64": x.astype(np.float64) * 7,
            "empty": np.zeros(0, np.float32)}


def _logged(cls, workdir, cases, fs):
    logger = cls(str(workdir))
    for step, (tag, wav) in enumerate(cases.items()):
        logger.log_audio(f"a/{tag}", wav, step, fs=fs)
    logger.close()
    return [e for e in read_events(str(workdir / "tb"))
            if e["kind"] == "audio"]


@pytest.mark.parametrize("fs", [8000, 16000])
def test_audio_summaries_equal_jax(tmp_path, fs):
    cases = _audio_cases()
    got = _logged(MetricsLogger, tmp_path / "port", cases, fs)
    want = _logged(JaxLogger, tmp_path / "jax", cases, fs)
    assert [e["tag"] for e in got] == [f"a/{k}" for k in cases
                                       if k != "empty"]
    assert got == want
    for e in got:
        assert e["fs"] == fs and e["wav"][:4] == b"RIFF"


def test_scalars_land_in_both_sinks(tmp_path):
    logger = MetricsLogger(str(tmp_path))
    logger.log({"train/loss": 0.5, "val/si_sdr": np.float32(3.25)}, 10)
    logger.log({"train/loss": 0.25}, 20)
    logger.close()
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [(r["step"], r["train/loss"]) for r in recs] == [(10, 0.5),
                                                            (20, 0.25)]
    assert recs[0]["val/si_sdr"] == 3.25
    tb = [(e["step"], e["tag"], e["value"])
          for e in read_events(str(tmp_path / "tb"))]
    assert tb == [(10, "train/loss", 0.5), (10, "val/si_sdr", 3.25),
                  (20, "train/loss", 0.25)]


def test_figure_and_the_disabled_logger(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    logger = MetricsLogger(str(tmp_path / "on"))
    fig, ax = plt.subplots()
    ax.plot([0, 1])
    logger.log_figure("val/spectrograms", fig, 4)
    logger.close()
    assert not plt.fignum_exists(fig.number)
    ev = read_events(str(tmp_path / "on" / "tb"))
    assert [(e["step"], e["tag"], e["kind"]) for e in ev] == [
        (4, "val/spectrograms", "image")]
    assert ev[0]["png"][:4] == b"\x89PNG"
    off = MetricsLogger(str(tmp_path / "off"), enabled=False)
    off.log({"a": 1.0}, 1)
    off.log_audio("x", np.ones(8), 1)
    off.close()
    assert not (tmp_path / "off").exists()


def test_guarded_prints_and_counts(tmp_path, capsys):
    logger = MetricsLogger(str(tmp_path), backend="none")
    calls = []
    logger.guarded("demo", 3, calls.append, 1)

    def boom():
        raise RuntimeError("kernel refused")

    logger.guarded("demo", 5, boom)
    logger.guarded("demo", 6, boom)
    logger.close()
    assert calls == [1] and logger.failures == 2
    err = capsys.readouterr().err
    assert "[demo] failed at step 5" in err and "kernel refused" in err
    assert "Traceback" in err
    assert not (tmp_path / "tb").exists()
