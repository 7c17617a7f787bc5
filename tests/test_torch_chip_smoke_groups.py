"""chip_smoke.py's phase groups, on the CPU without CUDA: every phase that
``main`` runs is in exactly one group of ``GROUPS`` (read from the
module, which imports nothing but the standard library at its top), and
the ``kernels`` line of a group run lists every kernel with the launches
of the paths that ran."""
import ast
import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _top_phases(mod):
    """The phase functions that take only the context: main runs them
    (the others, e.g. phase_serving_stream(ctx, eng, client), are run by
    a phase)."""
    return {n for n, f in vars(mod).items()
            if n.startswith("phase_") and inspect.isfunction(f)
            and list(inspect.signature(f).parameters) == ["ctx"]}


def test_every_phase_is_in_exactly_one_group(smoke):
    grouped = [n for g in smoke.GROUPS.values() for n in g]
    assert sorted(grouped) == sorted(set(grouped)), "a phase in two groups"
    assert set(grouped) == _top_phases(smoke)
    assert sorted(smoke.GROUPS) == [1, 2]
    assert "phase_mesh" in grouped
    assert {"phase_media", "phase_import"} <= set(smoke.GROUPS[1])


def test_main_runs_phases_only_through_the_groups(smoke):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    direct = [c.func.id for c in ast.walk(main) if isinstance(c, ast.Call)
              and isinstance(c.func, ast.Name)
              and c.func.id.startswith("phase_")]
    assert direct == []
    # a phase that reads another's results runs after it, in its group
    g1 = smoke.GROUPS[1]
    assert g1.index("phase_flagship") < g1.index("phase_families")


def test_kernels_line_of_a_group_run(smoke):
    """Group 2 measures no kernel's time: every kernel is listed, with
    null numbers and the launches of the paths group 2 ran."""
    ctx = {"latent_launches": {"evaluate_latent": 1080,
                               "train_cli_latent_diffsep_ouve":
                               {"fir_down2d": 420, "fir_up2d": 32}},
           "ldm_cache_launches": 2880,
           "serve_launches": {"serve_api": 12960},
           "mesh_launches": {"mesh_train_nccl": {"fir_down2d": 3, "fir_up2d":
                                                 7, "fba_fwd": 0}}}
    line = smoke.kernels_line(ctx, torch)
    by = {k["name"]: k for k in line}
    assert list(by) == ["fir_down2d", "fir_up2d", "fba_fwd", "fba_bwd",
                        "conv3x3_9tap", "conv3x3_async_halo"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in line)
    down = by["fir_down2d"]
    assert down["launches_by_path"] == {
        "evaluate_latent": 1080, "train_cli_latent_diffsep_ouve": 420,
        "ldm_cache_latents": 2880, "serve_api": 12960, "mesh_train_nccl": 3}
    assert down["launches"] == 1080 + 420 + 2880 + 12960 + 3
    assert down["ms"] is None and down["bound_ms"] is None
    assert by["fir_up2d"]["launches"] == 32 + 7


def test_kernels_line_sums_the_media_paths(smoke):
    """The media and import phases' paths count in both FIR kernels'
    launches, beside the main path's."""
    zero = {"fba_fwd": 0, "fba_bwd": 0, "conv3x3_9tap": 0,
            "conv3x3_async_halo": 0}
    ctx = {"main_path_launches": 4320,
           "media_launches": {
               "media_train_cli": {"fir_down2d": 2232, "fir_up2d": 24,
                                   **zero},
               "media_evaluate": {"fir_down2d": 180, "fir_up2d": 0, **zero},
               "import_separate": {"fir_down2d": 72, "fir_up2d": 0,
                                   **zero}}}
    by = {k["name"]: k for k in smoke.kernels_line(ctx, torch)}
    assert by["fir_down2d"]["launches"] == 4320
    assert by["fir_down2d"]["launches_by_path"] == {
        "separate_cli": 4320, "media_train_cli": 2232,
        "media_evaluate": 180, "import_separate": 72}
    assert by["fir_up2d"]["launches"] == 24 + 0 + 0
    assert by["fba_fwd"]["launches"] == 0
