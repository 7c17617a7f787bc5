"""Served stems of the real samplers against the JAX package's, on the CPU
(case (c) of the serving parity): ``cli.serve_api.build_engine`` on the
tiny NCSN++ config, unmasked and masked, and on the tiny latent config,
loading the JAX package's ``.npz`` exports, against JAX's
``BatchingEngine`` over ``trainer.separate`` / ``separate_latent`` given
the same draws. The port's engine draws from its own generator; its
draws, replayed in pc_sample's order (``sdes.samplers.
pc_generator_noise``), are JAX's ``noise=``. Bar: 1e-3 max|ref| (the
sampler's bar, tests/test_full_pipeline_parity.py). Three requests of
different lengths share one bucket, so the batch of 4 carries a padded
row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.serving import BatchingEngine as JaxEngine
from ditsep_tpu.utils.checkpoint import save_params_npz as jax_save_npz
from ditsep_tpu_torch.cli.serve_api import build_engine
from ditsep_tpu_torch.configs import diffsep, latent_diffsep_ouve, override
from ditsep_tpu_torch.sdes.samplers import pc_generator_noise
from ditsep_tpu_torch.serving import frame_block_padded_len
from test_torch_latent import TINY as LATENT_TINY
from test_torch_latent import tiny_latent_pair

TINY = {"model.score_model.nf": 16, "model.score_model.ch_mult": (1, 1),
        "model.score_model.num_res_blocks": 1,
        "model.score_model.attn_resolutions": (),
        "model.score_model.n_fft": 126, "model.score_model.hop_length": 32}
FRAME_SPEC = (126, 32, 64)
N, SEED, BATCH = 2, 5, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _requests(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(L)).astype(np.float32)
            for L in lengths]


def _serve(eng, audios):
    """Submit ``audios`` at once; their results and the engine's stats,
    the engine closed."""
    try:
        outs = [f.result(timeout=60) for f in
                [eng.submit(a) for a in audios]]
        return outs, eng.stats()
    finally:
        eng.close()


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return {"/".join(str(getattr(k, "key", k)) for k in kp):
            np.array(leaf) + 0.05 * rng.standard_normal(leaf.shape).astype(
                np.float32)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflat(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                           for k, a in flat.items()})


@pytest.mark.parametrize("masked", [False, True])
def test_served_stems_match_jax(masked, tmp_path):
    ov = {**TINY, "model.score_model.mask_padding": masked}
    jt = jax_build(jax_override(jax_diffsep(), ov))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 1000)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, 1000)))
    params = {"params": _unflat(_perturbed(tmpl["params"], 2))}
    npz = str(tmp_path / "score.npz")
    jax_save_npz(npz, params["params"])

    lengths = (1500, 1400, 1700)
    blen = frame_block_padded_len(max(lengths), FRAME_SPEC)
    assert all(frame_block_padded_len(L, FRAME_SPEC) == blen
               for L in lengths)
    audios = _requests(lengths)
    eng = build_engine(override(diffsep(), TINY), device="cpu",
                       params_npz=npz, sampler_N=N, mask_padding=masked,
                       max_batch=BATCH, max_wait_ms=300.0, seed=SEED)
    trainer = eng.separate_fn.trainer
    got, st = _serve(eng, audios)
    assert (st["batches"], st["padded_rows"]) == (1, 1)
    assert eng.separate_fn.nfe == 2 * N

    # the engine's draws, replayed: the direct call on its padded batch
    # gives the served rows bit for bit
    noise = pc_generator_noise(torch.Generator().manual_seed(SEED),
                               (BATCH, 2, blen), N)
    mix = np.zeros((BATCH, 1, blen), np.float32)
    lens = np.full((BATCH,), blen, np.int64)
    for i, a in enumerate(audios):
        mix[i, 0, :a.shape[-1]] = a
        lens[i] = a.shape[-1]
    direct, _ = trainer.separate(
        torch.from_numpy(mix), N=N, noise=noise,
        lengths=torch.from_numpy(lens) if masked else None)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, direct[i, :, :lengths[i]].numpy())

    noise_np = tuple(t.numpy() for t in noise)

    def jfn(key, y, *lens):
        return jt.separate(params, key, y, N=N, noise=noise_np,
                           lengths=lens[0] if lens else None)[0]

    want, jst = _serve(JaxEngine(jfn, max_batch=BATCH, max_wait_ms=300.0,
                                 frame_spec=FRAME_SPEC, pass_lengths=masked),
                       audios)
    assert (jst["batches"], jst["padded_rows"]) == (1, 1)
    for g, w in zip(got, want):
        _close(g, w)


def test_served_latent_stems_match_jax(tmp_path):
    jt, params, vae_params, tt = tiny_latent_pair()
    npz, vae_npz = str(tmp_path / "score.npz"), str(tmp_path / "vae.npz")
    jax_save_npz(npz, params["params"])
    jax_save_npz(vae_npz, vae_params["params"])
    hop, d = tt.vae.downsampling_ratio, 4
    lengths = (200, 190, 230)  # one bucket of 16 hops: 256 samples
    audios = _requests(lengths, seed=4)
    eng = build_engine(override(latent_diffsep_ouve(), LATENT_TINY),
                       device="cpu", params_npz=npz, vae_params_npz=vae_npz,
                       sampler_N=N, latent=True, max_batch=BATCH,
                       max_wait_ms=300.0, seed=SEED)
    assert eng.frame_spec is None and eng.bucket_multiple == 16 * hop
    blen = eng.bucket_of(max(lengths))
    assert blen == 256
    got, st = _serve(eng, audios)
    assert (st["batches"], st["padded_rows"]) == (1, 1)

    g = torch.Generator().manual_seed(SEED)
    enc = torch.randn((BATCH, d, blen // hop), generator=g).numpy()
    noise = tuple(t.numpy() for t in pc_generator_noise(
        g, (BATCH, 2, d, blen // hop), N))
    sep = jax.jit(lambda p, vp, k, y: jt.separate_latent(
        p, vp, k, y, target_dim=y.shape[-1], N=N, enc_noise=enc,
        noise=noise)[0])
    want, jst = _serve(JaxEngine(lambda k, y: sep(params, vae_params, k, y),
                                 max_batch=BATCH, max_wait_ms=300.0,
                                 frame_spec=None, bucket_multiple=16 * hop),
                       audios)
    assert (jst["batches"], jst["padded_rows"]) == (1, 1)
    for gi, w in zip(got, want):
        _close(gi, w)


def test_build_engine_latent_ab2():
    """serve_api --latent --sampler ab2 runs end to end through the
    engine (one score evaluation a step)."""
    eng = build_engine(override(latent_diffsep_ouve(), LATENT_TINY),
                       device="cpu", sampler_N=3, sampler="ab2",
                       latent=True, max_batch=2, max_wait_ms=40.0)
    outs, st = _serve(eng, _requests((400, 390), seed=6))
    for out in outs:
        assert out.shape[0] == 2 and np.isfinite(out).all()
    assert [o.shape[-1] for o in outs] == [400, 390]
    assert st["batches"] == 1 and eng.separate_fn.nfe == 3
