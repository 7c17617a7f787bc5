"""The waveform learning loop against the JAX package: the port's
``SyntheticTonalMixDataset`` gives the JAX dataset's arrays bit for bit;
``examples.train_synthetic`` at a tiny size prints the JAX script's keys
(examples/train_synthetic.py), takes its batches in the JAX script's order,
writes an EMA ``.npz`` that the JAX package's score model loads and runs
within 1e-4 of max|ref| of the port's EMA (the score-model bar), and
resumes bit for bit; ``examples.nfe_study``'s statistics on the per-seed
values of the committed study (docs/nfe_study.json, the JAX script's
output) give every mean, CI, deficit and upper bound there within 2e-3 (the
file rounds to 3 decimals) and every verdict, and a tiny study end to end
prints the file's keys, the baseline's deficit 0; both entry points refuse
to run without CUDA unless asked for the CPU."""
import ast
import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import CONFIG_FAMILIES as JAX_FAMILIES
from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.data import SyntheticTonalMixDataset as JaxTonal
from ditsep_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.data import SyntheticMixDataset, SyntheticTonalMixDataset
from ditsep_tpu_torch.examples import nfe_study, train_synthetic
from ditsep_tpu_torch.models.weights import save_params_npz

REPO = Path(__file__).resolve().parents[1]
TINY_ARGS = ["--cpu", "--nf", "16", "--steps", "3", "--batch", "2",
             "--n-train", "4", "--len-s", "0.5", "--eval-N", "2",
             "--eval-every", "2"]
LENGTH = 1200
DOC = json.loads((REPO / "docs" / "nfe_study.json").read_text())


@pytest.mark.parametrize("n_spkr", [2, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_tonal_dataset_is_jaxs_bit_for_bit(n_spkr, seed):
    kw = dict(n_items=4, n_spkr=n_spkr, min_len_s=0.3, max_len_s=1.2,
              seed=seed)
    ours, ref = SyntheticTonalMixDataset(**kw), JaxTonal(**kw)
    assert len(ours) == len(ref) == 4
    lengths = set()
    for i in range(4):
        assert ours.item_length(i) == ref.item_length(i)
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype == np.float32
            assert a.shape == b.shape and np.array_equal(a, b)
        assert ours[i][1].shape == (n_spkr, ours.item_length(i))
        lengths.add(ours.item_length(i))
    assert len(lengths) > 1  # mixed lengths


def _jax_result_keys():
    """The keys of the JAX script's interim and result JSON lines, read
    from its source (examples/train_synthetic.py)."""
    tree = ast.parse((REPO / "examples" / "train_synthetic.py").read_text())
    result = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    interim = next(n.args[0] for n in ast.walk(tree)
                   if isinstance(n, ast.Call) and n.args
                   and isinstance(n.args[0], ast.Dict)
                   and getattr(n.func, "attr", None) == "dumps")
    return ([k.value for k in interim.keys], [k.value for k in result.keys])


def _recipe_order(n_items, batch, steps):
    """The item indices the JAX script trains on, step by step
    (examples/train_synthetic.py:106-114, written out)."""
    order, out, i = np.arange(n_items), [], 0
    while i < steps:
        np.random.default_rng(i).shuffle(order)
        for s in range(0, len(order) - batch + 1, batch):
            out.append([int(j) for j in order[s:s + batch]])
            i += 1
            if i >= steps:
                break
    return out


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """train_synthetic.main at the tiny size, its stdout, the items each
    dataset handed out in order, and the .npz it wrote (its training
    state at step 2 beside it, ``--resume``)."""
    npz = tmp_path_factory.mktemp("run") / "ema.npz"
    fetched = []
    real = SyntheticMixDataset.__getitem__

    def logged(self, idx):
        fetched.append((self.seed, idx))
        return real(self, idx)

    mp = pytest.MonkeyPatch()
    mp.setattr(SyntheticMixDataset, "__getitem__", logged)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            run = train_synthetic.main([*TINY_ARGS, "--save-params",
                                        str(npz), "--resume",
                                        str(npz.with_suffix(".pt"))])
    finally:
        torch.set_num_threads(n)
        mp.undo()
    return run, out.getvalue().splitlines(), fetched, npz


def test_train_synthetic_prints_the_jax_scripts_keys(tiny_run):
    run, lines, _, npz = tiny_run
    interim_keys, result_keys = _jax_result_keys()
    lines = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(lines) == 2
    interim, result = lines
    assert list(interim) == interim_keys and interim["interim_step"] == 2
    assert list(result)[:len(result_keys)] == result_keys
    assert {"steps_per_s", "data_s", "eval_s", "peak_gib",
            "card"} <= set(result)
    assert result == run["result"] and run["interims"] == [interim]
    assert result["steps"] == 3 and result["final_loss"] is None
    assert result["card"] == "cpu" and result["peak_gib"] is None
    assert all(np.isfinite(result[k]) for k in result_keys[2:])
    assert len(run["losses"]) == 3 and np.isfinite(run["losses"]).all()
    assert npz.exists()


def test_train_synthetic_takes_the_recipes_batches(tiny_run):
    _, _, fetched, _ = tiny_run
    test_items = [(10_000, j) for j in range(8)]
    assert fetched[:8] == test_items  # the held-out batch, built first
    train = [idx for seed, idx in fetched[8:]]
    assert all(seed == 0 for seed, _ in fetched[8:])
    assert train == [j for b in _recipe_order(4, 2, 3) for j in b]


def test_recipe_batches_match_the_jax_order_across_epochs():
    """Five items at batch 2 leave one item out of each epoch; eight steps
    cross four epochs, each reshuffling the last order."""
    ds = SyntheticMixDataset(n_items=5, min_len_s=0.01, max_len_s=0.05)
    got = [b[0] for b in train_synthetic.recipe_batches(ds, 2, 8)]
    want = _recipe_order(5, 2, 8)
    assert len(got) == len(want) == 8
    for mix, idx in zip(got, want):
        ref = [ds[j][0] for j in idx]
        length = max(r.shape[-1] for r in ref)
        assert mix.shape == (2, 1, length)
        for row, r in zip(mix, ref):
            pad = length - r.shape[-1]
            assert np.array_equal(row[:, pad // 2:pad // 2 + r.shape[-1]], r)
    tail = [b[0] for b in train_synthetic.recipe_batches(ds, 2, 8, start=5)]
    assert len(tail) == 3
    assert all(np.array_equal(a, b) for a, b in zip(tail, got[5:]))
    with pytest.raises(ValueError, match="batch"):
        next(train_synthetic.recipe_batches(ds, 6, 1))


def test_saved_ema_runs_in_the_jax_model(tiny_run):
    run, _, _, npz = tiny_run
    jt = jax_build(jax_override(JAX_FAMILIES["diffsep"](), {
        "model.score_model.nf": 16,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)}))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, LENGTH)).astype(np.float32)
    t = np.array([0.4, 0.9], np.float32)
    y = rng.standard_normal((2, 1, LENGTH)).astype(np.float32)
    shapes = jax.eval_shape(jt.model.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, (x[:1], t[:1], y[:1])))
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        shapes["params"])
    params = {"params": jax_load_npz(str(npz), tmpl)}
    ref = np.asarray(jax.jit(jt.model.apply)(params, *map(jnp.asarray,
                                                          (x, t, y))))
    with torch.no_grad():
        got = run["state"].ema(*map(torch.from_numpy, (x, t, y))).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_resumed_run_equals_the_run_that_never_stopped(tiny_run, tmp_path):
    """The state the tiny run wrote at its step-2 interim, resumed for its
    last step (evaluated at N=1 here): the same loss, parameters, EMA and
    optimizer state bit for bit."""
    run, _, _, npz = tiny_run
    resume = tmp_path / "run.pt"
    resume.write_bytes(npz.with_suffix(".pt").read_bytes())
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            again = train_synthetic.main([*TINY_ARGS, "--eval-N", "1",
                                          "--resume", str(resume)])
    finally:
        torch.set_num_threads(n)
    assert again["interims"] == [] and len(again["losses"]) == 1
    assert again["losses"][0] == run["losses"][-1]
    want, got = run["state"].state_dict(), again["state"].state_dict()
    assert got["step"] == want["step"] == 3
    for part in ("model", "ema"):
        assert all(torch.equal(got[part][k], want[part][k])
                   for k in want[part])
    adam = (want["optimizer"]["adam"]["state"],
            got["optimizer"]["adam"]["state"])
    assert all(torch.equal(a[k][m], b[k][m]) for a, b in [adam]
               for k in a for m in a[k])


@pytest.mark.parametrize("main,argv", [
    (train_synthetic.main, ["--steps", "1"]),
    (nfe_study.main, ["--params", "unused.npz"])])
def test_entry_points_need_cuda_unless_asked_for_the_cpu(main, argv,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def test_statistics_reproduce_the_committed_study():
    per_seed = {k: v["si_sdr_per_seed"] for k, v in DOC["configs"].items()}
    nfe = {k: v["nfe"] for k, v in DOC["configs"].items()}
    got = nfe_study.summarize(per_seed, nfe, 0.5)
    assert list(got) == list(DOC["configs"])
    for name, want in DOC["configs"].items():
        assert list(got[name]) == list(want)
        for key, ref in want.items():
            if key == "accepted":
                assert got[name][key] is ref, name
            elif key == "si_sdr_per_seed":
                assert got[name][key] == ref
            else:
                assert abs(got[name][key] - ref) <= 2e-3, (name, key)


def test_mean_ci_of_one_value_has_no_interval():
    mean, ci = nfe_study._mean_ci([1.5])
    assert mean == 1.5 and np.isnan(ci)
    # one seed: the deficit's missing interval adds nothing to the bound
    got = nfe_study.summarize({"pc_N30": [2.0], "ab2_N8": [1.2]},
                              {"pc_N30": 60, "ab2_N8": 8}, 0.5)
    assert got["ab2_N8"]["deficit_upper95"] == 0.8
    assert got["ab2_N8"]["accepted"] is False


TINY_CONFIGS = {name: (sampler, min(n, 2))
                for name, (sampler, n) in nfe_study.CONFIGS.items()}


@pytest.fixture(scope="module")
def tiny_study(tmp_path_factory):
    """The study at nf=16 on 1 item of 0.5 s, 2 seeds, every
    configuration's N capped at 2 (``TINY_CONFIGS``), on a seeded model's
    .npz; its stdout lines."""
    npz = str(tmp_path_factory.mktemp("study") / "params.npz")
    model = build_diffsep_trainer(train_synthetic.synthetic_config(16),
                                  device="cpu", seed=5).model
    save_params_npz(npz, model)
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(out), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(nfe_study, "CONFIGS", TINY_CONFIGS)
            study = nfe_study.main([
                "--cpu", "--params", npz, "--nf", "16", "--len-s", "0.5",
                "--n-items", "1", "--n-seeds", "2"])
    finally:
        torch.set_num_threads(n)
    return study, [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_tiny_study_prints_the_committed_keys(tiny_study):
    study, lines = tiny_study
    assert lines[-1] == json.loads(json.dumps(study))
    assert [list(ln) for ln in lines[:-1]] == [[k] for k in DOC["configs"]]
    assert list(study)[:len(DOC)] == list(DOC)
    assert set(DOC["protocol"]) <= set(study["protocol"])
    assert list(study["configs"]) == list(DOC["configs"])
    for name, entry in study["configs"].items():
        assert list(entry) == list(DOC["configs"][name])
        assert len(entry["si_sdr_per_seed"]) == 2
        assert np.isfinite(entry["si_sdr_mean"])
    # N capped at 2: PC's NFE 2N, AB2's N
    assert {k: v["nfe"] for k, v in study["configs"].items()} == {
        "pc_N30": 4, "pc_N15": 4, "pc_N8": 4, "ab2_N30": 2, "ab2_N15": 2,
        "ab2_N8": 2}
    base = study["configs"]["pc_N30"]
    assert (base["deficit_vs_pc_N30_mean"], base["deficit_vs_pc_N30_ci95"],
            base["deficit_upper95"], base["accepted"]) == (0.0, 0.0, 0.0,
                                                           True)
    assert np.isfinite(study["mixture_baseline_si_sdr"])


def test_study_needs_the_baseline():
    with pytest.raises(ValueError, match="pc_N30"):
        nfe_study.main(["--cpu", "--params", "unused.npz", "--configs",
                        "pc_N15"])


def test_learning_path_shapes_are_the_loops(monkeypatch):
    """``fir_timing.learning_path_shapes``, at which chip_smoke's learning
    phase holds fir_down2d and fir_up2d against their plain versions, are
    the inputs of ``ops.fir.downsample_2d`` in a separation by
    train_synthetic's model (nf=32) of the recipe's 4 s items: 9 a
    forward, the down blocks' twice (h and the skip x)."""
    from ditsep_tpu_torch.ops import fir
    from ditsep_tpu_torch.scripts import fir_timing

    seen = []
    real = fir.downsample_2d
    monkeypatch.setattr(fir, "downsample_2d", lambda x, *a, **kw: seen.append(
        tuple(x.shape)) or real(x, *a, **kw))
    trainer = build_diffsep_trainer(train_synthetic.synthetic_config(32),
                                    device="cpu", seed=0)
    mix, _ = train_synthetic.test_batch(1, 4.0, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, nfe = trainer.separate(mix, N=1,
                                  generator=torch.Generator().manual_seed(0))
    finally:
        torch.set_num_threads(n)
    want = fir_timing.learning_path_shapes(batch=1)
    assert len(seen) == nfe * (2 * 3 + 3)
    assert set(seen) == {s for _, _, s in want}
    assert [seen.count(s) for _, _, s in want] == [
        nfe * (2 if kind == "down" else 1) for kind, _, _ in want]
    assert (fir_timing.LEARN_BATCH, fir_timing.LEARN_FRAMES) == (
        8, seen[0][-1])

