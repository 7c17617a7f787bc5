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


def test_kernels_line_lists_the_generation_path(smoke):
    """The generation phase's path runs no kernel: every kernel lists it
    with 0 launches."""
    zero = {k: 0 for k in ("fir_down2d", "fir_up2d", "fba_fwd", "fba_bwd",
                           "conv3x3_9tap", "conv3x3_async_halo")}
    line = smoke.kernels_line({"generation_launches": zero}, torch)
    assert all(k["launches_by_path"]["generation_full"] == 0
               for k in line if "launches_by_path" in k)
    assert "phase_generation" in smoke.GROUPS[2]


def test_generation_configs_are_stable_audio_open(smoke):
    """The full-width config has Stable Audio Open 1.0's widths (the
    DiT's parameter count on the meta device: no memory), 1,024 latent
    frames for 2,097,152 samples; the small one its schema."""
    from ditsep_tpu_torch.models.factory import (
        create_diffusion_cond_from_config)
    with torch.device("meta"):
        dit, routing, cfgs, pre = create_diffusion_cond_from_config(
            smoke.SAO_FULL, include_pretransform=True)
    n = sum(p.numel() for p in dit.parameters())
    assert 1.05e9 < n < 1.1e9
    assert (dit.embed_dim, len(dit.transformer.layers()),
            dit.transformer.dim_heads) == (1536, 24, 64)
    assert smoke.SAO_SAMPLE_SIZE // pre.downsampling_ratio == 1024
    assert (pre.encoded_channels, pre.io_channels) == (64, 2)
    assert routing.cross_attn_cond_ids == ("prompt", "seconds_start",
                                           "seconds_total")
    assert routing.global_cond_ids == ("seconds_start", "seconds_total")
    small = smoke.GEN_SMALL["model"]
    assert set(small) == set(smoke.SAO_FULL["model"])


def test_generation_phase_rehearsed_on_the_cpu(smoke, monkeypatch,
                                               tmp_path):
    """The phase's parts on the CPU (CUDA calls patched to no-ops, the
    profiler's replay skipped): the small config's four generation cases
    (card and CPU both the CPU here), the three routes byte-equal to the
    direct calls, a full-width run at a tiny width and the importer, every
    launch count 0."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "profile_replay", lambda run: {
        "nfe": run(), "wall_ms": 0.0, "device_busy_ms": 0.0,
        "idle_share": None, "top": []})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = {"card": "CPU"}
        par = smoke.gen_parity(ctx, device="cpu")
        assert set(par["card_vs_cpu_rel"]) == {"v", "k_heun", "rf_euler",
                                               "variation_inpaint"}
        http = smoke.gen_http(ctx, tmp_path, device="cpu")
        assert not any(http["launches"].values())
        tiny = smoke.sao_config(smoke.GEN_SMALL_VAE, 8, 32, 8, {
            "embed_dim": 64, "depth": 2, "num_heads": 2})
        full = smoke.gen_full(ctx, tiny, 1024, device="cpu")
        assert len(full["step_s"]) == (smoke.GEN_FULL_REQUESTS
                                       * smoke.GEN_FULL_STEPS)
        assert (full["cfg_rows"], full["tokens"]) == (2, 1024 // 32 + 1)
        assert not any(full["launches"].values())
        imp = smoke.gen_importer(full["app"], full["probe"], tiny,
                                 device="cpu")
        assert imp["bit_equal"]
    finally:
        torch.set_num_threads(n)


def test_kernels_line_lists_the_stable_models_path(smoke):
    """The stable_models phase's path runs no kernel: every kernel lists
    it with 0 launches; the phase is in group 2, before mesh."""
    zero = {k: 0 for k in ("fir_down2d", "fir_up2d", "fba_fwd", "fba_bwd",
                           "conv3x3_9tap", "conv3x3_async_halo")}
    line = smoke.kernels_line({"stable_launches": zero}, torch)
    assert all(k["launches_by_path"]["stable_lm_full"] == 0
               for k in line if "launches_by_path" in k)
    g2 = smoke.GROUPS[2]
    assert g2.index("phase_stable_models") < g2.index("phase_mesh")


def test_stable_models_configs(smoke):
    """The full-width LM has MusicGen-small's widths (about 0.42 B
    parameters, counted on the meta device) over DAC 44 kHz's 9 codebooks
    of 1024 (hop 512, latent 1024); DAU1d's config is the reference
    class's defaults (stereo, depth 14)."""
    from ditsep_tpu_torch.models.factory import (
        create_model_from_config, create_pretransform_from_config)
    with torch.device("meta"):
        lm, pattern = create_model_from_config(smoke.LM_FULL)
        pre = create_pretransform_from_config(
            smoke.LM_FULL["model"]["pretransform"])
        dau = create_model_from_config(smoke.DAU_FULL)
    n = sum(p.numel() for p in lm.parameters())
    assert 0.40e9 < n < 0.44e9
    assert (lm.dim, lm.depth, lm.num_heads, lm.n_quantizers,
            lm.codebook_size) == (1024, 24, 16, 9, 1024)
    assert pattern.extra_steps == 8
    assert (pre.downsampling_ratio, pre.encoded_channels,
            pre.num_quantizers, pre.codebook_size) == (512, 1024, 9, 1024)
    assert smoke.LM_FULL_LENGTH * pre.downsampling_ratio == 88064
    assert (dau.io_channels, dau.depth) == (2, 14)


def test_stable_models_phase_rehearsed_on_the_cpu(smoke, monkeypatch):
    """The phase's parts on the CPU (CUDA calls patched to no-ops, the
    profiler's replay run once unprofiled): the small configs' card-vs-CPU
    checks (both the CPU here), /api/lm's WAV and codes equal to the
    direct calls, the LM path with a tiny LM over the DAC 44 kHz codec
    (5 frames), DAU1d at a tiny width and its importer; every launch
    count 0."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "profile_replay", lambda run: {
        "nfe": run(), "wall_ms": 0.0, "device_busy_ms": 0.0,
        "idle_share": None, "top": []})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = {"card": "CPU", "bandwidth": 3.35e12}
        par = smoke.stable_parity(ctx, device="cpu")
        assert set(par["card_vs_cpu_rel"]) == set(par["bars"])
        http = smoke.stable_http(ctx, device="cpu")
        assert http["codes"]["shape"] == [1, 4, 16]
        tiny = {**smoke.LM_FULL, "model": {
            **smoke.LM_FULL["model"], "lm": {"config": {
                "n_quantizers": 9, "codebook_size": 1024, "embed_dim": 32,
                "depth": 2, "num_heads": 2}}}}
        full = smoke.stable_lm_full(ctx, tiny, 5, device="cpu")
        assert full["decode_step_s"]["n"] == (smoke.LM_FULL_REQUESTS
                                              * (5 + 8 - 1))
        assert full["cached_vs_full_rel"] <= 1e-4
        assert not any(full["launches"].values())
        dau = smoke.stable_dau(ctx, {"model_type": "diffusion_uncond",
                                     "model": {"type": "DAU1d", "config": {
                                         "depth": 3, "n_attn_layers": 1,
                                         "channels": [8, 8, 32],
                                         "strides": [2, 2]}}}, 64,
                               device="cpu")
        assert len(dau["step_s"]) == smoke.DAU_STEPS
        assert dau["importer"]["bit_equal"]
    finally:
        torch.set_num_threads(n)


def test_stable_train_phase_is_in_group_2_and_lists_its_paths(smoke):
    """The stable_train phase runs no kernel: every kernel lists its paths
    with 0 launches; it is in group 2, after stable_models and before
    mesh."""
    g2 = smoke.GROUPS[2]
    assert (g2.index("phase_stable_models") < g2.index("phase_stable_train")
            < g2.index("phase_mesh"))
    zero = {k: 0 for k in ("fir_down2d", "fir_up2d", "fba_fwd", "fba_bwd",
                           "conv3x3_9tap", "conv3x3_async_halo")}
    paths = {"stable_train_parity": zero, "stable_train_cli_lm": zero,
             "stable_train_dit": zero}
    line = smoke.kernels_line({"stable_train_launches": paths}, torch)
    assert all(k["launches_by_path"] == dict.fromkeys(paths, 0)
               and k["launches"] == 0 for k in line
               if "launches_by_path" in k)


def test_stable_train_children_are_the_published_widths(smoke):
    """The children's configs: the Stable Audio Open 1.0 VAE (157 M
    parameters, hop 2048, 64 latents, stereo) against DAC's published
    discriminator, counted on the meta device; the LM's 86 frames."""
    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.training.factory import create_trainer_from_config
    cfg, batch, size, steps, demo = smoke.STABLE_CHILDREN["autoencoder"]
    with torch.device("meta"):
        vae = create_model_from_config(cfg)
        tr = create_trainer_from_config(cfg, vae)
    assert (vae.downsampling_ratio, vae.latent_dim, vae.out_channels) == (
        2048, 64, 2)
    assert 1.5e8 < sum(p.numel() for p in vae.parameters()) < 1.7e8
    assert [m.period for m in tr.disc.mpds] == [2, 3, 5, 7, 11]
    assert [m.window_length for m in tr.disc.mrds] == [2048, 1024, 512]
    assert len(tr.disc.mrds[0].bands) == 5 and (batch, size) == (2, 65536)
    lm_cfg, batch, size, steps, demo = smoke.STABLE_CHILDREN["lm"]
    assert (batch, size // 2048, steps) == (4, 86, 4)
    assert 0 < demo < steps



def test_slice_phases_are_in_group_1_and_list_their_paths(smoke):
    """The SepFormer, backbones, NCSN++ option and streaming-bench phases
    are in group 1; the kernels line lists their paths (the option configs'
    and the streaming bench's fir_down2d launches, the others 0)."""
    g1 = smoke.GROUPS[1]
    new = ("phase_sepformer", "phase_backbones", "phase_ncsnpp_options",
           "phase_streaming_bench")
    assert all(n in g1 for n in new)
    assert g1.index("phase_import") < g1.index("phase_sepformer")
    zero = {k: 0 for k in ("fir_down2d", "fir_up2d", "fba_fwd", "fba_bwd",
                           "conv3x3_9tap", "conv3x3_async_halo")}
    paths = {"sepformer_cli": zero, "sepformer_parity": zero,
             "backbones": zero, "ncsnpp_ddpm_fir": {**zero, "fir_down2d": 12},
             "ncsnpp_biggan_residual": {**zero, "fir_down2d": 12},
             "streaming_bench": {**zero, "fir_down2d": 4320}}
    by = {k["name"]: k for k in smoke.kernels_line(
        {"slice_launches": paths}, torch)}
    assert by["fir_down2d"]["launches_by_path"] == {
        k: v["fir_down2d"] for k, v in paths.items()}
    assert by["fir_down2d"]["launches"] == 12 + 12 + 4320
    assert by["fir_up2d"]["launches"] == 0
    assert set(by["fir_up2d"]["launches_by_path"]) == set(paths)


def test_option_configs_launch_fir_down2d_twelve_times(smoke, monkeypatch):
    """A forward of each option config at the flagship's depth (7 levels,
    attention at 16; nf=4 on a 64 x 64 input on the CPU) calls
    ``ops.fir.downsample_2d``, fir_down2d's wrapper on the card,
    OPTION_LAUNCHES_PER_FORWARD (12) times; the flagship's own BigGAN +
    input_skip config LAUNCHES_PER_FORWARD (18) times."""
    from ditsep_tpu_torch.models import NCSNpp
    from ditsep_tpu_torch.examples import nfe_study
    from ditsep_tpu_torch.ops import fir
    calls = []
    real = fir.downsample_2d
    monkeypatch.setattr(fir, "downsample_2d",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(nf=4, ch_mult=(1, 1, 2, 2, 2, 2, 2), attn_resolutions=(16,),
              image_size=64, num_channels_in=6, num_channels_out=4)

    def fir_downsamples(opts):
        model = NCSNpp(**kw, **opts).eval()
        calls.clear()
        with torch.no_grad():
            model(torch.zeros(1, 6, 64, 64), torch.full((1,), 0.5))
        return len(calls)

    assert smoke.OPTION_LAUNCHES_PER_FORWARD == 12
    for opts in smoke.OPTION_CONFIGS.values():
        assert fir_downsamples(opts) == smoke.OPTION_LAUNCHES_PER_FORWARD
    assert fir_downsamples({}) == smoke.LAUNCHES_PER_FORWARD


def test_facodec_phase_is_in_group_1_once(smoke):
    grouped = [n for g in smoke.GROUPS.values() for n in g]
    assert grouped.count("phase_facodec") == 1
    assert "phase_facodec" in smoke.GROUPS[1]


def test_facodec_phase_rehearsed_on_the_cpu(smoke):
    """The phase's parts on the CPU: the small codec (card and CPU both
    the CPU here), the demo CLI at the shipped widths on two short files
    (its WAVs read through the native library where it builds), and
    model_info's totals, which are the JAX package's ``eval_shape``
    counts written into the script (the demo's decoder counted here by
    ``jax.eval_shape``)."""
    import jax
    import jax.numpy as jnp

    from ditsep_tpu.models.facodec import FACodecDecoder
    from ditsep_tpu_torch import native

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        par = smoke.facodec_parity(device="cpu")
        assert par["codes_equal"]
        assert par["frames_clearing_margin"] == par["frames"] == 800
        assert all(v == 0.0 for k, v in par.items() if k.endswith("_rel"))
        if native.available():
            demo = smoke.facodec_demo({"card": "CPU"}, device="cpu",
                                      lengths=(3210, 2400))
            assert demo["native_reads"] == 4
            assert not any(demo["launches"].values())
            assert demo["peak_gib"] is None and len(demo["file_s"]) == 2
            assert len(demo["file_s_repeat"]) == 2
        totals = {**smoke.model_info_totals(["--facodec"]),
                  **smoke.model_info_totals(["--config", "diffsep_icassp"])}
        assert totals == smoke.JAX_PARAMS
    finally:
        torch.set_num_threads(n)
    shapes = jax.eval_shape(lambda k, h: FACodecDecoder(
        upsample_initial_channel=1024).init(k, h, return_info=True),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 256, 8),
                                                    jnp.float32))
    assert sum(s.size for s in jax.tree.leaves(shapes)) \
        == smoke.FACODEC_DEMO_DECODER_PARAMS


def test_learning_phase_is_in_group_1_once(smoke):
    grouped = [n for g in smoke.GROUPS.values() for n in g]
    assert grouped.count("phase_learning") == 1
    assert "phase_learning" in smoke.GROUPS[1]


def test_learning_loop_rehearsed_on_the_cpu(smoke, monkeypatch):
    """The learning phase's loop on the CPU at a tiny size (4 steps, N=2,
    the study's configurations at N=2): finite losses, the interim and the
    final evaluation, the EMA export equal to the EMA bit for bit (checked
    inside), and the calls of ``ops.fir.downsample_2d`` (fir_down2d's
    wrapper on the card) of each path as ``launches_want`` counts them."""
    from ditsep_tpu_torch.examples import nfe_study
    from ditsep_tpu_torch.ops import fir

    calls = []
    real = fir.downsample_2d
    monkeypatch.setattr(fir, "downsample_2d",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(smoke, "reset_counts", calls.clear)
    monkeypatch.setattr(smoke, "counts", lambda: {"fir_down2d": len(calls),
                                                  "fir_up2d": 0})
    monkeypatch.setattr(nfe_study, "CONFIGS", {
        name: (sampler, 2) for name, (sampler, _) in
        nfe_study.CONFIGS.items()})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rec = smoke.learning_loop(device="cpu", nf=16, batch=2, len_s=0.5,
                                  steps=4, items=4, eval_n=2, eval_every=2)
    finally:
        torch.set_num_threads(n)
    assert len(rec["losses"]) == 4 and rec["evaluations"] == 2
    assert [i["interim_step"] for i in rec["interims"]] == [2]
    assert set(rec["study"]["configs"]) == set(smoke.LEARN_STUDY)
    for path, got in rec["launches"].items():
        assert got["fir_down2d"] == rec["launches_want"][path]["fir_down2d"]
    assert rec["launches"]["learning_train"]["fir_down2d"] == (
        (4 * 2 + 2 * 2 * 4) * smoke.CKPT_LAUNCHES_PER_FORWARD)


def test_run_shares_one_bytecode_cache(smoke, monkeypatch):
    """``share_bytecode_cache`` points this process and its children at
    one bytecode cache in the checkout and lets them write it."""
    import os
    import sys
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.setenv("PYTHONPYCACHEPREFIX", "elsewhere")
    smoke.share_bytecode_cache()
    want = str(smoke.REPO / "build" / "pycache")
    assert sys.pycache_prefix == want == os.environ["PYTHONPYCACHEPREFIX"]
    assert not sys.dont_write_bytecode
    assert "PYTHONDONTWRITEBYTECODE" not in os.environ
