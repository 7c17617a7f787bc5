"""``python -m ditsep_tpu_torch.cli.train_stable --cpu`` end to end on
tiny configs of its three model types (the VAE-GAN with a DAC
discriminator, DAU1d, the token LM), in this process: the final JSON,
the checkpoints, a demo logged to TensorBoard, and ``--resume`` from a
``--ckpt-every`` checkpoint equal, bit for bit, to the run that was not
stopped (each step's draws a function of (seed, step)); without --cpu on
a machine without CUDA it raises, and it refuses conditional diffusion
with the JAX CLI's message.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from ditsep_tpu_torch.cli import train_stable
from tb_events import read_events

CONFIGS = {
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
            "bottleneck": {"type": "vae"}, "latent_dim": 4},
        "training": {"learning_rate": 1e-3, "loss_configs": {
            "spectral": {"weights": {"mrstft": 1.0}},
            "discriminator": {"type": "dac", "config": {
                "periods": [], "fft_sizes": [256],
                "bands": [[0.0, 0.5], [0.5, 1.0]]}}},
            "demo": {"demo_every": 3, "max_num_sample": 1}}},
    "diffusion_uncond": {
        "model_type": "diffusion_uncond", "sample_rate": 8000,
        "sample_size": 256,
        "model": {"type": "DAU1d", "config": {
            "io_channels": 1, "depth": 3, "channels": [8, 8, 8],
            "strides": [2, 2], "n_attn_layers": 1}},
        "training": {"learning_rate": 1e-3, "demo": {
            "demo_every": 3, "demo_steps": 2, "num_demos": 1}}},
    "lm": {
        "model_type": "lm", "sample_rate": 8000, "sample_size": 16384,
        "model": {"lm": {"type": "continuous_transformer", "config": {
            "n_quantizers": 2, "codebook_size": 16, "embed_dim": 32,
            "depth": 1, "num_heads": 2}}},
        "training": {"learning_rate": 1e-3, "demo": {
            "demo_every": 3, "num_demos": 1}}},
}
DEMO_TAGS = {"autoencoder": "demo/recon/0", "diffusion_uncond":
             "demo/cfg_1/0", "lm": "demo/token_max"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, kind) -> str:
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(CONFIGS[kind]))
    return str(path)


def _run(capsys, cfg, work, *extra):
    out = train_stable.main(["--model-config", cfg, "--workdir", str(work),
                             "--batch-size", "2", "--cpu", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    return out, lines


def _final_state(work: Path) -> dict:
    (path,) = [p for p in work.glob("step-*") if p.is_dir()]
    return torch.load(path / "state.pt", map_location="cpu")


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_stable_cli_runs_and_resumes_bit_for_bit(kind, tmp_path,
                                                       capsys):
    cfg = _config(tmp_path, kind)
    whole, _ = _run(capsys, cfg, tmp_path / "whole", "--max-steps", "5",
                    "--ckpt-every", "2")
    assert whole["steps"] == 5 and whole["media_failures"] == 0
    assert all(torch.isfinite(torch.tensor(v)) for v in
               whole["final"].values())
    assert "train/loss" in whole["final"]
    work = tmp_path / "whole"
    assert (work / "latest" / "state.pt").exists()
    assert (work / "index.json").exists() and (work / "best-model").exists()
    tags = {e["tag"] for e in read_events(str(work / "tb"))}
    assert DEMO_TAGS[kind] in tags and "train/loss" in tags
    # stopped after step 2 (its --ckpt-every checkpoint), then resumed
    cut = tmp_path / "cut"
    _run(capsys, cfg, cut, "--max-steps", "3", "--ckpt-every", "2")
    resumed, lines = _run(capsys, cfg, cut, "--max-steps", "5",
                          "--ckpt-every", "2", "--resume")
    assert json.loads(lines[0]) == {"resumed_at_step": 3}
    assert resumed == whole
    for p in cut.glob("step-00000003*"):  # the stopped run's own end
        shutil.rmtree(p)
    assert _equal(_final_state(cut), _final_state(work))


def test_train_stable_cli_refusals(tmp_path, monkeypatch):
    cond = tmp_path / "cond.json"
    cond.write_text(json.dumps({"model_type": "diffusion_cond",
                                "model": {}}))
    with pytest.raises(SystemExit, match="not trainable from this generic"):
        train_stable.main(["--model-config", str(cond), "--cpu",
                           "--workdir", str(tmp_path / "w")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_stable.main(["--model-config", _config(tmp_path, "lm"),
                           "--workdir", str(tmp_path / "w")])
