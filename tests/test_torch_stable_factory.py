"""The port's training and demo factories (``training/factory.py``,
``training/demo.py``) against the JAX package's on the CPU, with configs
built here from the fields of tests/test_training_factory.py (the
reference JSONs are not in the repository).

Bars, stated before the runs: ``create_trainer_from_config`` on every
model type gives the JAX factory's trainer, field for field (the
autoencoder's discriminator its family, with the model's channels and
rate; a teacher loaded from its ``.npz`` bit for bit, and refused
without one), and a trainer that takes a finite step;
``create_demo_callback_from_config`` on every type the JAX callback's
fields; the diffusion demo on a small DAU1d (kwargs it does not take
filtered) 1e-3 of max|ref| of JAX's, from JAX's noise, at two CFG scales;
the LM demo's tokens exact on JAX's Gumbel draws (every step's top-2
margin above 1e-3, tests/test_torch_lm.py), and their range logged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import factory as jmf
from ditsep_tpu.training import demo as jdemo
from ditsep_tpu.training import factory as jtf
from ditsep_tpu_torch.models import factory as tmf
from ditsep_tpu_torch.models import lm as tl
from ditsep_tpu_torch.models.weights import save_params_npz
from ditsep_tpu_torch.training import demo as tdemo
from ditsep_tpu_torch.training import factory as ttf
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw
from test_torch_lm import _jax_draws, _sampled_with_margins


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oobleck_block(in_channels=1):
    return {
        "encoder": {"type": "oobleck", "config": {
            "in_channels": in_channels, "channels": 4, "latent_dim": 8,
            "c_mults": [1, 2], "strides": [2, 2]}},
        "decoder": {"type": "oobleck", "config": {
            "out_channels": in_channels, "channels": 4, "latent_dim": 4,
            "c_mults": [1, 2], "strides": [2, 2]}},
        "bottleneck": {"type": "vae"}, "latent_dim": 4}


def _dit(**extra):
    return {"type": "dit", "io_channels": 2,
            "config": {"io_channels": 2, "embed_dim": 32, "depth": 1,
                       "num_heads": 2}, **extra}


CONFIGS = {
    "autoencoder": {
        "model_type": "autoencoder", "sample_rate": 16000,
        "model": _oobleck_block(2),
        "training": {
            "learning_rate": 1.5e-4, "warmup_steps": 3,
            "encoder_freeze_on_warmup": True, "latent_mask_ratio": 0.1,
            "loss_configs": {
                "spectral": {"weights": {"mrstft": 1.0}},
                "time": {"weights": {"l1": 0.5}},
                "bottleneck": {"weights": {"kl": 1e-4}},
                "discriminator": {
                    "type": "dac", "config": {
                        "periods": [2], "fft_sizes": [128], "channels": 1},
                    "weights": {"adversarial": 0.2,
                                "feature_matching": 4.0}}},
            "optimizer_configs": {
                "autoencoder": {"optimizer": {"type": "AdamW", "config": {
                    "lr": 1e-4, "betas": [0.8, 0.99]}}, "scheduler": {
                    "type": "InverseLR", "config": {"inv_gamma": 1000}}},
                "discriminator": {"optimizer": {"type": "Adam", "config": {
                    "lr": 2e-4, "weight_decay": 1e-3}}}},
            "demo": {"demo_every": 7, "max_num_sample": 2}}},
    "diffusion_autoencoder": {
        "model_type": "diffusion_autoencoder", "sample_rate": 8000,
        "model": {"latent_dim": 3, "downsampling_ratio": 4, "io_channels": 1,
                  "encoder": {"type": "oobleck", "config": {
                      "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
                      "latent_dim": 3}},
                  "diffusion": {"type": "adp_1d", "config": {
                      "in_channels": 4, "out_channels": 1, "channels": 8,
                      "multipliers": [1, 2], "factors": [2],
                      "num_blocks": [1], "attentions": [0, 1]}}},
        "training": {"learning_rate": 2e-4,
                     "timestep_sampler": "logit_normal"}},
    "diffusion_uncond": {
        "model_type": "diffusion_uncond", "sample_rate": 8000,
        "sample_size": 64,
        "model": {"type": "DAU1d", "config": {
            "io_channels": 1, "depth": 2, "channels": [4, 8],
            "strides": [2], "n_attn_layers": 1}},
        "training": {"learning_rate": 3e-4, "demo": {
            "demo_every": 5, "demo_steps": 3, "num_demos": 2,
            "demo_cfg_scales": [1, 3]}}},
    "diffusion_cond": {
        "model_type": "diffusion_cond", "sample_rate": 8000,
        "model": {"diffusion": _dit(
            diffusion_objective="rectified_flow",
            global_cond_ids=["seconds"],
            config={"io_channels": 2, "embed_dim": 32, "depth": 1,
                    "num_heads": 2, "global_cond_dim": 4})},
        "training": {"learning_rate": 1e-4, "cfg_dropout_prob": 0.2,
                     "timestep_sampler": "trunc_logit_normal"}},
    "diffusion_cond_inpaint": {
        "model_type": "diffusion_cond_inpaint", "sample_rate": 8000,
        "model": {"diffusion": _dit(
            input_concat_ids=["inpaint_mask", "inpaint_masked_input"],
            config={"io_channels": 2, "embed_dim": 32, "depth": 1,
                    "num_heads": 2, "input_concat_dim": 3})},
        "training": {"learning_rate": 1e-4, "max_mask_segments": 4,
                     "timestep_sampler": "uniform"}},
    "diffusion_prior": {
        "model_type": "diffusion_prior", "sample_rate": 8000,
        "model": {"diffusion": _dit(
            input_concat_ids=["source"],
            config={"io_channels": 2, "embed_dim": 32, "depth": 1,
                    "num_heads": 2, "input_concat_dim": 2})},
        "training": {"learning_rate": 1e-4, "prior_type": "mono_stereo"}},
    "lm": {
        "model_type": "lm", "sample_rate": 8000, "sample_size": 8192,
        "model": {"lm": {"type": "continuous_transformer",
                         "codebook_pattern": "delay",
                         "config": {"n_quantizers": 2, "codebook_size": 16,
                                    "embed_dim": 32, "depth": 1,
                                    "num_heads": 2}}},
        "training": {"learning_rate": 5e-3, "optimizer_configs": {
            "lm": {"optimizer": {"type": "AdamW", "config": {
                "lr": 5e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}}}},
            "demo": {"demo_every": 3, "num_demos": 2}}},
}
SKIP_FIELDS = {"model", "vae", "disc", "teacher_vae", "teacher_params",
               "routing", "vae_tx", "disc_tx", "pattern"}


def _fields(obj) -> dict:
    """A trainer's or callback's fields but its modules, a nested
    dataclass as a dict."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(obj) if f.name not in SKIP_FIELDS
            for v in (getattr(obj, f.name),)}


def _batch(cfg, model):
    """A small batch for one step of the port's trainer."""
    g = torch.Generator().manual_seed(0)
    kind = cfg["model_type"]
    if kind == "lm":
        return torch.randint(0, 16, (2, 2, 8), generator=g)
    if kind == "autoencoder":
        return 0.3 * torch.randn(2, 2, 256, generator=g)
    if kind == "diffusion_autoencoder":
        return 0.3 * torch.randn(2, 1, 32, generator=g)
    return 0.3 * torch.randn(2, 2 if kind != "diffusion_uncond" else 1, 16,
                             generator=g)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_create_trainer_from_config_matches_jax(kind):
    cfg = CONFIGS[kind]
    jtr = jtf.create_trainer_from_config(cfg, jmf.create_model_from_config(
        cfg))
    model = tmf.create_model_from_config(cfg)
    ttr = ttf.create_trainer_from_config(cfg, model)
    assert type(ttr).__name__ == type(jtr).__name__
    assert _fields(ttr) == _fields(jtr)
    if kind == "autoencoder":
        assert type(ttr.disc).__name__ == type(jtr.disc).__name__
        assert ttr.disc.mpds[0].convs[0].weight_v.shape[1] == 2  # stereo
        assert ttr.vae_tx.kind == "AdamW" and ttr.disc_tx.kind == "Adam"
        assert ttr.vae_tx.schedule(10) == pytest.approx(
            float(jax_schedule(cfg)(jnp.asarray(10, jnp.int32))), rel=1e-6)
    if kind.startswith("diffusion_cond") or kind == "diffusion_prior":
        assert ttr.routing == model[1]
        assert dataclasses.asdict(ttr.routing) == dataclasses.asdict(
            jtr.routing)
    state = ttr.init_state()
    x = _batch(cfg, model)
    g = torch.Generator().manual_seed(1)
    if kind == "autoencoder":
        state, m = ttr.gen_step(state, x, False, generator=g)
    elif kind == "lm":
        state, m = ttr.train_step(state, x)
    elif kind == "diffusion_autoencoder":
        state, m = ttr.train_step(state, x, generator=g)
    else:
        cond = ({"seconds": (torch.randn(2, 1, 4, generator=g),
                             torch.ones(2, 1, dtype=torch.bool))}
                if kind == "diffusion_cond" else None)
        state, m = ttr.train_step(state, x, cond, generator=g)
    assert state.step == 1 and np.isfinite(m["train/loss"].item())


def jax_schedule(cfg):
    from ditsep_tpu.training.schedules import create_schedule_from_config
    oc = cfg["training"]["optimizer_configs"]["autoencoder"]
    return create_schedule_from_config(oc["scheduler"],
                                       oc["optimizer"]["config"]["lr"])


def test_teacher_loads_from_its_checkpoint_and_is_required(tmp_path):
    cfg = {**CONFIGS["autoencoder"], "training": {
        **CONFIGS["autoencoder"]["training"],
        "teacher_model": {"model_type": "autoencoder",
                          "model": _oobleck_block(2)}}}
    with pytest.raises(ValueError, match="teacher_model_ckpt"):
        ttf.create_trainer_from_config(cfg, tmf.create_model_from_config(
            cfg))
    teacher = tmf.create_model_from_config(
        cfg["training"]["teacher_model"], torch.Generator().manual_seed(9))
    save_params_npz(str(tmp_path / "teacher.npz"), teacher)
    cfg["training"]["teacher_model_ckpt"] = str(tmp_path / "teacher.npz")
    tr = ttf.create_trainer_from_config(cfg, tmf.create_model_from_config(
        cfg))
    for k, v in teacher.state_dict().items():
        assert torch.equal(tr.teacher_vae.state_dict()[k], v), k


def test_factory_refusals():
    for mod in (jtf, ttf):
        with pytest.raises(NotImplementedError):
            mod.create_trainer_from_config(
                {"model_type": "nope", "training": {}}, None)
    with pytest.raises(ValueError):
        ttf.create_trainer_from_config({"model_type": "lm"}, None)
    with pytest.raises(NotImplementedError):
        tdemo.create_demo_callback_from_config(
            {"model_type": "nope", "training": {}})


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_create_demo_callback_from_config_matches_jax(kind):
    cfg = CONFIGS[kind]
    jcb = jdemo.create_demo_callback_from_config(cfg, io_channels=5)
    tcb = tdemo.create_demo_callback_from_config(cfg, io_channels=5)
    assert type(tcb).__name__ == type(jcb).__name__
    assert _fields(tcb) == _fields(jcb)


class Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.audio, self.scalars, self.failures = {}, {}, 0

    def log_audio(self, tag, wav, step, fs=8000):
        self.audio[tag] = np.asarray(wav)

    def log(self, metrics, step):
        self.scalars.update(metrics)

    def guarded(self, what, step, fn, *args, **kwargs):
        fn(*args, **kwargs)


def test_diffusion_demo_matches_jax():
    cfg = CONFIGS["diffusion_uncond"]
    jnet, tnet = (jmf.create_model_from_config(cfg),
                  tmf.create_model_from_config(cfg))
    params = redraw(init_shapes(jnet, jnp.zeros((1, 1, 64)),
                                jnp.zeros((1,))), 3)
    load_jax(tnet, params)
    jcb = jdemo.create_demo_callback_from_config(cfg, io_channels=1)
    tcb = tdemo.create_demo_callback_from_config(cfg, io_channels=1)
    key = jax.random.PRNGKey(4)
    jrec, trec = Recorder(), Recorder()
    jcb(jrec, 5, jnet, params, key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key)[0], (2, 1, 64))))
    tcb(trec, 5, tnet, noise=noise)
    assert set(trec.audio) == set(jrec.audio) == {
        f"demo/cfg_{s}/{i}" for s in (1, 3) for i in range(2)}
    for tag, want in jrec.audio.items():
        assert max_rel(torch.from_numpy(trec.audio[tag]), want) <= 1e-3, tag


class TokenSink:
    """A discrete pretransform stand-in that keeps the tokens it is
    given."""

    downsampling_ratio = 4

    def __init__(self):
        self.tokens = None

    def decode_tokens(self, tokens):
        self.tokens = np.asarray(tokens)
        return (tokens[:, :1] * 1.0 if isinstance(tokens, torch.Tensor)
                else jnp.asarray(tokens[:, :1], jnp.float32))


def test_lm_demo_matches_jax():
    cfg = CONFIGS["lm"]
    (jlm, jpat), (tlm, tpat) = (jmf.create_model_from_config(cfg),
                                tmf.create_model_from_config(cfg))
    params = redraw(init_shapes(jlm, jnp.zeros((1, 2, 5), jnp.int32)), 6)
    load_jax(tlm, params)
    tlm.eval()
    jcb = jdemo.create_demo_callback_from_config(cfg, pattern=jpat)
    tcb = tdemo.create_demo_callback_from_config(cfg, pattern=tpat)
    key, length = jax.random.PRNGKey(7), 5
    steps = length + 1  # the delay pattern of 2 codebooks
    jsink, tsink, jrec, trec = TokenSink(), TokenSink(), Recorder(), \
        Recorder()
    jcb(jrec, 3, jlm, params, key, pretransform=jsink, length=length)
    draws = _jax_draws(key, steps, (2, 2, 16))
    tcb(trec, 3, tlm, pretransform=tsink, length=length, gumbel=draws)
    # top-k at the codebook size masks nothing: the demo samples all
    _, gaps = _sampled_with_margins(tlm, steps, draws, {}, 16, 0.0, 1.0, 0)
    assert min(gaps) > 1e-3, gaps
    assert tsink.tokens.shape == (2, 2, length)
    np.testing.assert_array_equal(tsink.tokens, jsink.tokens)
    assert trec.scalars == jrec.scalars
    assert set(trec.audio) == set(jrec.audio) == {"demo/lm/0", "demo/lm/1"}
    # from a generator, without a pretransform: the range alone
    rec = Recorder()
    tcb(rec, 3, tlm, generator=torch.Generator().manual_seed(0), length=3)
    assert set(rec.scalars) == {"demo/token_min", "demo/token_max"}
    assert not rec.audio
    assert isinstance(tpat, tl.DelayPattern)
