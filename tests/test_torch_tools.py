"""The port's tools off the model paths against the JAX package's on the
CPU: ``utils/{misc,profiling,processing_pool,import_module,hub}.py``,
``eval/dnsmos.py`` and ``native.py`` (with ``data.read_wav`` and
``max_collator`` through it); ``cli/model_info.py`` in
tests/test_torch_model_info.py.

Bars, stated before the runs: ``solve_psd_loaded`` 1e-5 abs;
``StandardScaler``'s state and transforms bit for bit; the clip
thresholds and scaled updates, the parameter counts, the split paths, the
instantiated objects and the finite-check messages equal; the DNSMOS merge's
JSON files byte for byte and its warning the same; the native WAV reads,
writes and collations bit for bit (skipped only where ``g++`` is absent);
the hub loader's weights ``params_from_jax`` of JAX's bit for bit."""
import io
import json
import os
import shutil
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import flat

import ditsep_tpu.utils.misc as JM
import ditsep_tpu_torch.utils.misc as PM

NEEDS_GXX = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build native/ditsep_io.cpp")


# ------------------------------------------------------------------ misc --
def test_solve_psd_loaded_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 5))
    a = (a @ a.transpose(0, 2, 1) + 2 * np.eye(5)).astype(np.float32)
    b = rng.standard_normal((3, 5, 2)).astype(np.float32)
    want = np.asarray(JM.solve_psd_loaded(jnp.asarray(a), jnp.asarray(b),
                                          load=1e-2))
    got = PM.solve_psd_loaded(torch.from_numpy(a), torch.from_numpy(b),
                              load=1e-2).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_standard_scaler_bits():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((200, 3)) * [1.0, 2.0, 0.5] + 1.0
    jsc, psc = JM.StandardScaler(3), PM.StandardScaler(3)
    for chunk in np.array_split(data, 7):
        jsc.update(chunk)
        psc.update(torch.from_numpy(chunk) if len(chunk) % 2 else chunk)
    assert psc.count == jsc.count
    for k in ("mean", "m2", "var", "std"):
        assert np.array_equal(getattr(psc, k), getattr(jsc, k)), k
    x = data[:9].astype(np.float32)
    z = np.asarray(jsc.transform(jnp.asarray(x)))
    assert np.array_equal(psc.transform(torch.from_numpy(x)).numpy(), z)
    assert np.array_equal(
        psc.inverse_transform(torch.from_numpy(z)).numpy(),
        np.asarray(jsc.inverse_transform(jnp.asarray(z))))


def test_autoclipper_and_clip_update():
    norms = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    jc, pc = JM.AutoClipper(30), PM.AutoClipper(30)
    assert [pc.threshold(g) for g in norms] == [jc.threshold(g)
                                                 for g in norms]
    rng = np.random.default_rng(2)
    ups = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": rng.standard_normal((5,)).astype(np.float32)}
    for gnorm, thr in ((7.5, 2.0), (0.5, 2.0)):
        want = JM.clip_update_by_threshold(
            {k: jnp.asarray(v) for k, v in ups.items()},
            jnp.asarray(gnorm, jnp.float32), thr)
        got = PM.clip_update_by_threshold(
            {k: torch.from_numpy(v) for k, v in ups.items()},
            torch.tensor(gnorm), thr)
        for k in ups:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_count_parameters_and_split_directory(tmp_path):
    tree = {"a": jnp.ones((2, 3)), "b": {"c": jnp.ones((4,))}}
    assert PM.count_parameters({"a": torch.ones(2, 3), "c": np.ones(4)}) \
        == JM.count_parameters(tree) == 10
    assert PM.count_parameters(torch.nn.Linear(3, 4)) == 16
    jd = JM.SplitDirectory(str(tmp_path / "j"), max_files=2)
    pd = PM.SplitDirectory(str(tmp_path / "p"), max_files=2)
    jp = [os.path.relpath(jd.next_path(f"f{i}"), tmp_path / "j")
          for i in range(5)]
    pp = [os.path.relpath(pd.next_path(f"f{i}"), tmp_path / "p")
          for i in range(5)]
    assert pp == jp


def test_utils_exports_match_jax():
    import ditsep_tpu.utils as ju
    import ditsep_tpu_torch.utils as pu
    names = {n for n in vars(ju) if not n.startswith("_")
             and not isinstance(getattr(ju, n), type(ju))}
    assert names <= set(vars(pu))


# ------------------------------------------------ import_module and pools --
def test_import_module_matches_jax():
    from ditsep_tpu.utils import import_module as JI
    from ditsep_tpu_torch.utils import import_module as PI
    cfg = {"_target_": "collections.OrderedDict", "a": 1}
    assert PI.module_from_config(cfg, b=2) == JI.module_from_config(cfg, b=2)
    fn = {"_target_": "builtins.max", "default": 0}
    assert PI.run_configured_func(fn, [3, 9]) == \
        JI.run_configured_func(fn, [3, 9]) == 9
    assert PI.import_name("os.path.join") is JI.import_name("os.path.join")
    for mod in (JI, PI):
        with pytest.raises(ImportError, match="bare name"):
            mod.import_name("join")


def test_processing_pool():
    from ditsep_tpu_torch.utils.processing_pool import (
        ProcessingPool, SyncProcessingPool,
    )
    done = []
    pool = ProcessingPool(2)
    pool.push(lambda a, b=0: a + b, 1, b=2, callback=done.append)
    pool.push(lambda: 1 / 0)
    assert pool.join() == [3, None]
    assert done == [3] and "ZeroDivisionError" in pool.errors[0]
    pool.close()
    sync = SyncProcessingPool(2)
    for i in range(3):
        sync.push(lambda i=i: i * i)
    assert len(sync) == 3 and [sync.pop() for _ in range(3)] == [0, 1, 4]
    with pytest.raises(IndexError):
        sync.pop()
    sync.close()


# -------------------------------------------------------------- profiling --
def test_finite_checks_match_jax():
    from ditsep_tpu.utils import profiling as JP
    from ditsep_tpu_torch.utils import profiling as PP
    bad = {"ok": np.ones(3, np.float32),
           "net": {"w": np.array([1.0, np.nan, np.inf], np.float32)}}
    msgs = []
    for mod, tree in ((JP, bad), (PP, {"ok": torch.ones(3), "net": {
            "w": torch.tensor([1.0, float("nan"), float("inf")])}})):
        with pytest.raises(FloatingPointError) as e:
            mod.check_finite(tree, "grads")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("non-finite values in grads:net/w "
                                  "(nan=1, inf=1)")
    PP.check_finite({"a": [torch.ones(2), 1.0]})
    for metrics in ({"loss": 1.0, "x": torch.tensor(2.0)},
                    {"loss": float("nan")}):
        assert PP.finite_guard(metrics) == JP.finite_guard(
            {k: float(v) for k, v in metrics.items()})


def test_trace_annotate_ticker_and_nan_debugging(tmp_path):
    from ditsep_tpu_torch.utils import profiling as PP
    with PP.trace(str(tmp_path / "tb")):
        with PP.annotate("region_a"):
            torch.ones(4).sum()
    (f,) = os.listdir(tmp_path / "tb")
    events = json.loads((tmp_path / "tb" / f).read_text())["traceEvents"]
    assert any(e.get("name") == "region_a" for e in events)
    t = PP.Ticker()
    t.tick("a")
    t.tick("a")
    t.tick("b")
    assert set(t.summary()) == {"a", "b"} and t.summary()["a"] >= 0
    off = PP.Ticker(enabled=False)
    off.tick("a")
    assert off.summary() == {}
    was = torch.is_anomaly_enabled()
    try:
        PP.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


# ----------------------------------------------------------------- DNSMOS --
def test_merge_dnsmos_byte_equal_to_jax(tmp_path):
    from ditsep_tpu.eval.dnsmos import merge_dnsmos as jax_merge
    from ditsep_tpu_torch.eval.dnsmos import merge_dnsmos as port_merge
    results = {"1": {"si_sdr": [7.0, 8.0], "batch_idx": 0},
               "2": {"si_sdr": [5.0, float("nan")], "pesq": 2.5},
               "3": {"si_sdr": [1.0, 2.0]}}
    csv = ("filename,OVRL,SIG,BAK\n0001.enh0.wav,3.0,3.2,3.4\n"
           "0001.enh1.wav,3.2,,3.6\n0002.enh0.wav,2.0,2.2,2.4\n"
           "0099.enh0.wav,9.9,9.9,9.9\nnoindex.wav,1,1,1\n")
    msgs = {}
    for name, merge in (("jax", jax_merge), ("port", port_merge)):
        d = tmp_path / name
        d.mkdir()
        (d / "test.json").write_text(json.dumps(results))
        (d / "test_summary.json").write_text(json.dumps(
            {"si_sdr": 0.0, "number": 0, "runtime": 1.5}))
        (d / "dnsmos.csv").write_text(csv)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            merge(str(d / "test.json"), str(d / "dnsmos.csv"),
                  out_json=str(d / "merged.json"))
        msgs[name] = [str(x.message).replace(str(d), "D") for x in w]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            merge(str(d / "test.json"), str(d / "dnsmos.csv"),
                  filename_index_re=r"^(\d+)\.enh1")
    assert msgs["port"] == msgs["jax"] and "2 CSV row(s)" in msgs["jax"][0]
    for f in ("merged.json", "merged_summary.json", "test.json",
              "test_summary.json"):
        assert (tmp_path / "port" / f).exists() == \
            (tmp_path / "jax" / f).exists(), f
        if (tmp_path / "jax" / f).exists():
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f


# ----------------------------------------------------------------- native --
@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """int16 mono and stereo WAVs (scipy-written), and a float32 one."""
    from scipy.io import wavfile
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(3)
    paths = {}
    for name, shape in (("mono", (1001,)), ("stereo", (777, 2))):
        paths[name] = str(d / f"{name}.wav")
        wavfile.write(paths[name], 16000, rng.integers(
            -32768, 32767, shape).astype(np.int16))
    paths["float"] = str(d / "float.wav")
    wavfile.write(paths["float"], 8000,
                  (0.3 * rng.standard_normal(500)).astype(np.float32))
    return paths


@NEEDS_GXX
@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_native_load_and_read_wav_bit_equal(wavs, kind):
    from ditsep_tpu import native as jn
    from ditsep_tpu.data.wsj0_mix import read_wav as jax_read
    from ditsep_tpu_torch import native as pn
    from ditsep_tpu_torch.data import read_wav
    assert pn.available() and jn.available()
    n = pn.calls["load_wav"]
    got, want = pn.load_wav(wavs[kind]), jn.load_wav(wavs[kind])
    assert got[1] == want[1] == 16000
    assert got[0].dtype == np.float32 and np.array_equal(got[0], want[0])
    (a, fs), (b, jfs) = read_wav(wavs[kind]), jax_read(wavs[kind])
    assert fs == jfs and a.shape == b.shape and np.array_equal(a, b)
    assert a.shape == ((1001,) if kind == "mono" else (2, 777))
    # a path object through the library, a file object (a tar member's
    # bytes) through scipy: the same bits
    c, _ = read_wav(Path(wavs[kind]))
    with open(wavs[kind], "rb") as f:
        d, _ = read_wav(io.BytesIO(f.read()))
    assert np.array_equal(c, a) and np.array_equal(d, a)
    assert pn.calls["load_wav"] == n + 3
    assert pn.library_path().parent.name == "ditsep_tpu_torch"


@NEEDS_GXX
def test_native_write_and_collate_bit_equal(tmp_path, wavs):
    from ditsep_tpu import native as jn
    from ditsep_tpu.data.wsj0_mix import max_collator as jax_collate
    from ditsep_tpu_torch import native as pn
    from ditsep_tpu_torch.data import max_collator
    rng = np.random.default_rng(4)
    x = (0.5 * rng.standard_normal((2, 300))).astype(np.float32)
    assert pn.write_wav(str(tmp_path / "p.wav"), x, 8000)
    assert jn.write_wav(str(tmp_path / "j.wav"), x, 8000)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    sigs = [x[0, :100], x[1, :37], x[0, :250]]
    assert np.array_equal(pn.collate_center(sigs, 260),
                          jn.collate_center(sigs, 260))
    n = pn.calls["collate_center"]
    batch = [(x[:1, :100], x[:, :100]), (x[:1, :91], x[:, :91])]
    for align in ("center", "left"):
        got, want = max_collator(batch, align=align), jax_collate(
            batch, align=align)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert pn.calls["collate_center"] == n + 2  # the centred fields only
    # a file the decoder refuses falls back to scipy in both
    from ditsep_tpu.data.wsj0_mix import read_wav as jax_read
    from ditsep_tpu_torch.data import read_wav
    (a, fs), (b, jfs) = read_wav(wavs["float"]), jax_read(wavs["float"])
    assert fs == jfs == 8000 and np.array_equal(a, b)


# -------------------------------------------------------------------- hub --
def test_hub_loader_matches_jax(tmp_path, monkeypatch):
    import functools

    from ditsep_tpu.configs import build_diffsep_trainer as jax_build
    from ditsep_tpu.configs import diffsep as jax_diffsep
    from ditsep_tpu.configs import override as jax_override
    from ditsep_tpu.utils import hub as jax_hub
    from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep
    from ditsep_tpu_torch.configs import override
    from ditsep_tpu_torch.models.weights import params_from_jax
    from ditsep_tpu_torch.utils import hub
    from test_torch_train import TINY

    src = build_diffsep_trainer(override(diffsep(), TINY), device="cpu",
                                seed=3).model
    sd = {"score_model.backbone.sigmas": torch.linspace(0.05, 0.5, 10)}
    sd.update({f"score_model.backbone.{k}": v for k, v in
               src.backbone.state_dict().items()})
    path = tmp_path / "epoch=029.ckpt"
    torch.save({"state_dict": sd, "epoch": 29}, path)

    jm = jax_build(jax_override(jax_diffsep(), TINY)).model

    class Template(type(jm)):
        """JAX's model whose init gives zeros of its shapes: the hub
        loader uses it as a template and replaces every leaf."""

        def init(self, rngs, *args, **kw):
            shapes = jax.eval_shape(functools.partial(super().init, **kw),
                                    rngs, *args)
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    jm = Template(**{f: getattr(jm, f) for f in jm.__dataclass_fields__
                     if f not in ("parent", "name")})
    want = jax_hub.load_reference_diffsep_params(jm, str(path))
    fresh = build_diffsep_trainer(override(diffsep(), TINY), device="cpu",
                                  seed=4).model
    assert hub.load_reference_diffsep_params(fresh, str(path)) is fresh
    want_state = params_from_jax(flat(want["params"]), fresh)
    got = fresh.state_dict()
    assert want_state.keys() == got.keys()
    assert all(torch.equal(got[k], v) for k, v in want_state.items())
    assert all(torch.equal(got[k], v) for k, v in
               src.state_dict().items())

    # a bare state file with an ``ema`` entry: both refuse use_ema
    bare = tmp_path / "bare.pt"
    torch.save({**sd, "ema": torch.zeros(1)}, bare)
    for mod, model in ((jax_hub, jm), (hub, fresh)):
        with pytest.raises(NotImplementedError, match="EMA"):
            mod.load_reference_diffsep_params(model, str(bare), use_ema=True)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for mod in (jax_hub, hub):
        with pytest.raises(ImportError, match="huggingface_hub"):
            mod.download_checkpoint()
