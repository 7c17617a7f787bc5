"""chip_smoke.py's stable_train phase rehearsed on the CPU without CUDA
(the CUDA calls patched to no-ops): its parts run at tiny widths, in a
file of its own beside tests/test_torch_chip_smoke_groups.py so that each
file stays short."""
import importlib.util
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


def test_stable_train_phase_rehearsed_on_the_cpu(smoke, monkeypatch,
                                                 tmp_path):
    """The phase's parts on the CPU (CUDA calls patched to no-ops): the
    small trainers card vs CPU (both the CPU here), the three CLI children
    with --cpu at tiny widths (one demo each, 0 launches), and the DiT
    step on a tiny Stable Audio Open config."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx = {"card": "CPU"}
        par = smoke.stable_train_parity(ctx, device="cpu", discs={
            "dac": {"type": "dac", "config": {"periods": [2],
                                              "fft_sizes": [256]}},
            "oobleck": smoke.STABLE_AE_DISCS["oobleck"]})
        assert set(par) >= {"diffusion", "diffae", "lm", "vaegan_dac",
                            "vaegan_oobleck"}
        assert not any(par["launches"].values())
        vae = {"in_channels": 2, "channels": 4, "c_mults": [1, 2],
               "strides": [2, 4], "use_snake": True}
        ae = {**smoke.SAO_AE, "model": {
            "encoder": {"type": "oobleck", "config": {**vae,
                                                      "latent_dim": 8}},
            "decoder": {"type": "oobleck", "config": {
                **{k: v for k, v in vae.items() if k != "in_channels"},
                "out_channels": 2, "latent_dim": 4}},
            "bottleneck": {"type": "vae"}, "latent_dim": 4},
            "training": {**smoke.SAO_AE["training"], "loss_configs": {
                "discriminator": {"type": "dac", "config": {
                    "periods": [2], "fft_sizes": [256]}}}}}
        lm = {**smoke.LM_FULL, "model": {"lm": {"config": {
            "n_quantizers": 2, "codebook_size": 16, "embed_dim": 16,
            "depth": 1, "num_heads": 2}}}, "training": smoke.STABLE_CHILDREN[
            "lm"][0]["training"]}
        dau = {**smoke.STABLE_CHILDREN["diffusion_uncond"][0], "model": {
            "type": "DAU1d", "config": {"depth": 2, "n_attn_layers": 1,
                                        "channels": [4, 8],
                                        "strides": [2]}}}
        cli = smoke.stable_train_cli(ctx, {
            "lm": (lm, 2, 16384, 4, 3), "diffusion_uncond": (dau, 2, 64, 3, 2),
            "autoencoder": (ae, 2, 1024, 4, 2)}, cpu=True, root=tmp_path)
        assert all(len(v["step_s"]) == s for v, s in zip(
            cli.values(), (4, 3, 4)))
        assert cli["autoencoder"]["kinds"] == ["gen", "disc"] * 2
        tiny = smoke.sao_config(smoke.GEN_SMALL_VAE, 8, 32, 8, {
            "embed_dim": 64, "depth": 2, "num_heads": 2})
        dit = smoke.stable_dit_full(ctx, tiny, 1024, device="cpu")
        assert len(dit["losses"]) == smoke.STABLE_DIT_STEPS
        assert dit["latent_shape"] == [1, 8, 32]
    finally:
        torch.set_num_threads(n)
