"""The port's ``cli/model_info.py`` against the JAX package's on the CPU:
the printed inventory (the totals and the groups, at depth 1, and at the
default depth 2 where JAX's ``eval_shape`` is cheap) equals the JAX CLI's
line for line for the tiny waveform config, a latent config, FACodec at
its shipped widths, and a small autoencoder and LM JSON written here. The
port builds every model on the meta device."""
import contextlib
import io
import json

import pytest

TINY_WAVEFORM = ["model.score_model.nf=16",
                 "model.score_model.ch_mult=(1, 1)",
                 "model.score_model.attn_resolutions=()",
                 "model.sampler.N=2"]
TINY_LATENT = ["model.score_model.nf=16", "model.score_model.ch_mult=(1, 2)",
               "model.score_model.attn_resolutions=()",
               "model.score_model.image_size=4", "model.vae.channels=8",
               "model.vae.c_mults=(1, 2)", "model.vae.strides=(2, 4)",
               "model.vae.latent_dim=4"]
SMALL_MODEL_CONFIGS = {
    "autoencoder": {
        "model_type": "autoencoder", "sample_rate": 8000,
        "sample_size": 1024,
        "model": {
            "encoder": {"type": "oobleck", "config": {
                "in_channels": 1, "channels": 4, "c_mults": [1, 2],
                "strides": [2, 4], "latent_dim": 8}},
            "decoder": {"type": "oobleck", "config": {
                "out_channels": 1, "channels": 4, "c_mults": [1, 2],
                "strides": [2, 4], "latent_dim": 4}},
            "bottleneck": {"type": "vae"}, "latent_dim": 4}},
    "lm": {
        "model_type": "lm", "sample_rate": 8000, "sample_size": 16384,
        "model": {"lm": {"type": "continuous_transformer", "config": {
            "n_quantizers": 2, "codebook_size": 16, "embed_dim": 32,
            "depth": 1, "num_heads": 2}}}},
}


# ------------------------------------------------------------- model_info --
@pytest.mark.parametrize("case", ["waveform", "latent", "facodec",
                                  "autoencoder", "lm"])
def test_model_info_prints_jax_inventory(case, tmp_path):
    from ditsep_tpu.cli.model_info import main as jax_main
    from ditsep_tpu_torch.cli.model_info import main as port_main
    if case in SMALL_MODEL_CONFIGS:
        path = tmp_path / f"{case}.json"
        path.write_text(json.dumps(SMALL_MODEL_CONFIGS[case]))
        argv = ["--model-config", str(path)]
    else:
        argv = {"waveform": ["--config", "diffsep", "--override",
                             *TINY_WAVEFORM],
                "latent": ["--config", "latent_diffsep_ouve", "--override",
                           *TINY_LATENT],
                "facodec": ["--facodec"]}[case]
    # JAX's CLI traces FACodec at a dummy input length, which the inventory
    # does not depend on; a short one keeps its eval_shape cheap. The port
    # builds on the meta device and has no such flag.
    jax_argv = argv + ["--length", "1000"] if case == "facodec" else argv
    for depth in ("1",) if case in ("latent", "facodec") else ("1", "2"):
        outs = []
        for main, args in ((jax_main, jax_argv), (port_main, argv)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(args + ["--depth", depth])
            outs.append(buf.getvalue())
        assert outs[1] == outs[0]
        assert "parameters" in outs[0]
