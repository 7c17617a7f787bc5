"""The LDM decoder finetune's and the VAE-GAN's gen and disc steps over two
gloo ranks on the CPU (a batch of 4 split 2 + 2, the VAE-GAN's draws
passed in) against the one-process steps on the 4, at the train-step bars with
the rate each AdamW update applied (tests/test_torch_parallel.py states
them). The PIT minimum of the MRSTFT couples the batch: over the ranks it
takes the permutation of least global loss. ``normalize_losses=True``
divides the feature matching by a whole-batch mean, so over two ranks it
raises. ``pit_min`` alone: the loss 1e-6 relative, the gradient 1e-7 abs.

No JAX import at the top: the spawned ranks import this module.
"""
import numpy as np
import pytest
import torch

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.models.discriminators import (
    encodec_discriminator_loss,
)
from ditsep_tpu_torch.scripts import dryrun_multichip as dry
from ditsep_tpu_torch.training.schedules import inverse_lr_schedule
from test_torch_parallel import B, check_grads, check_step, run_ranks


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(params: dict, loss_fn, mesh):
    with torch.enable_grad(), parallel.sharded(mesh):
        grads = list(torch.autograd.grad(loss_fn(), list(params.values()),
                                         allow_unused=True))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    parallel.all_reduce_grads_(grads, mesh)
    return {k: g.numpy() for k, g in zip(params, grads)}


def _after(state_mod, ema_mod, metrics):
    return {"metrics": dry.scalars(metrics),
            "state": dry.float_state(state_mod.state_dict()),
            "ema": dry.float_state(ema_mod.state_dict())}


def ldm_case(mesh):
    """The dryrun's LDM leg, each step's gradient taken first."""
    from ditsep_tpu_torch.training.ldm import LDMLossWeights, LDMTrainer

    lt = dry.latent_trainer("cpu")
    rng = np.random.default_rng(3)
    reals = (0.3 * rng.standard_normal((B, 2, 512))).astype(np.float32)
    with torch.no_grad():
        _, lat = lt.encode(torch.from_numpy(reals[:, :1]),
                           torch.from_numpy(reals))
    ldm = LDMTrainer(
        latent_trainer=lt, disc=dry.seeded_disc(2, "cpu", 64, 16), lr=1e-3,
        weights=LDMLossWeights(fft_sizes=(256, 128), hop_sizes=(64, 32),
                               perceptual_weighting=False, l1=1.0,
                               adversarial=0.1, feature_matching=1.0))
    return ldm_steps(mesh, ldm, lat.numpy(), reals)


def ldm_steps(mesh, ldm, lat, reals):
    """A gen step (warmed up) then a disc step of ``ldm`` on the global
    batch (numpy latents and reals; this rank's rows with ``mesh``), each
    step's gradient taken first."""
    lt = ldm.latent_trainer
    state = ldm.init_state()
    lat_r, reals_r = dry.rank_rows(mesh, lat, reals)
    out = {}
    g = _grads(dict(state.decoder.named_parameters()),
               lambda: ldm.gen_loss(lat_r, reals_r, True)[0], mesh)
    state, m = ldm.gen_step(state, lat_r, reals_r, warmed_up=True,
                            mesh=mesh)
    out["gen"] = {"grads": g, **_after(state.decoder, state.ema_decoder, m)}
    decoded = lt.decode(lat_r, reals_r.shape[-1])
    g = _grads(dict(state.disc.named_parameters()),
               lambda: encodec_discriminator_loss(state.disc, reals_r,
                                                  decoded)[0], mesh)
    state, m = ldm.disc_step(state, lat_r, reals_r, mesh=mesh)
    # the discriminator has no EMA: its state is held twice
    out["disc"] = {"grads": g, **_after(state.disc, state.disc, m)}
    rate = inverse_lr_schedule(ldm.lr)(0)
    out["rates"] = {"gen": rate, "disc": 2 * rate}
    out["decay"] = {"gen": ldm.ema_decay, "disc": 0.0}
    return out


def vaegan_draws(vae_hop=8, d=4):
    rng = np.random.default_rng(7)
    return {"enc_z": rng.standard_normal(
        (B, d, 1024 // vae_hop)).astype(np.float32)}


def vaegan_case(mesh, draws):
    """The dryrun's VAE-GAN leg with explicit draws, each step's gradient
    taken first."""
    from ditsep_tpu_torch.models.oobleck import OobleckVAE
    from ditsep_tpu_torch.training.autoencoder import (
        AutoencoderLossConfig, AutoencoderTrainer,
    )

    vae = OobleckVAE(channels=8, c_mults=(1, 2), strides=(2, 4),
                     latent_dim=4)
    vae.reset_parameters(torch.Generator().manual_seed(4))
    tr = AutoencoderTrainer(
        vae=vae, disc=dry.seeded_disc(1, "cpu", 128, 32), lr=1e-3,
        loss_cfg=AutoencoderLossConfig(fft_sizes=(256, 128),
                                       hop_sizes=(64, 32),
                                       perceptual_weighting=False))
    rng = np.random.default_rng(5)
    reals = (0.3 * rng.standard_normal((B, 1, 1024))).astype(np.float32)
    return vaegan_steps(mesh, tr, reals, draws)


def vaegan_steps(mesh, tr, reals, draws, disc_draws=None):
    """A gen step (warmed up) then a disc step of the VAE-GAN trainer
    ``tr`` on the global batch ``reals`` (numpy; this rank's rows with
    ``mesh``) with the global batch's ``draws`` (``disc_draws`` for the
    disc step, ``draws`` by default), each step's gradient taken first."""
    from ditsep_tpu_torch.models.discriminators import discriminator_loss

    disc_draws = draws if disc_draws is None else disc_draws
    (reals_r,) = dry.rank_rows(mesh, reals)
    state = tr.init_state()
    out = {}
    g = _grads(dict(state.vae.named_parameters()),
               lambda: tr.gen_loss(reals_r, True, draws=draws)[0], mesh)
    state, m = tr.gen_step(state, reals_r, warmed_up=True, draws=draws,
                           mesh=mesh)
    out["gen"] = {"grads": g, **_after(state.vae, state.ema_vae, m)}
    with torch.no_grad(), parallel.sharded(mesh):
        decoded, reals_t, _, _ = tr._roundtrip(reals_r, None, disc_draws)
    g = _grads(dict(state.disc.named_parameters()),
               lambda: discriminator_loss(state.disc, reals_t, decoded)[0],
               mesh)
    state, m = tr.disc_step(state, reals_r, draws=disc_draws, mesh=mesh)
    out["disc"] = {"grads": g, **_after(state.disc, state.disc, m)}
    out["rates"] = {"gen": inverse_lr_schedule(tr.lr)(0),
                    "disc": inverse_lr_schedule(tr.disc_lr)(0)}
    out["decay"] = {"gen": tr.ema_decay, "disc": 0.0}
    return out


def normalized_fm_refusal(mesh) -> str:
    """The error ``normalize_losses=True`` raises in a rank's shard."""
    disc = dry.seeded_disc(1, "cpu", 128, 32)
    x = torch.zeros(2, 1, 1024)
    try:
        with parallel.sharded(mesh):
            encodec_discriminator_loss(disc, x, x, normalize_losses=True)
    except NotImplementedError as e:
        return str(e)
    return ""


def pit_case(mesh):
    """``pit_min`` of an L1 loss where rank 1's rows alone would take the
    swapped permutation and the global batch the straight one (rank 0's
    rows are louder): the loss averaged over the ranks, and its gradient
    with respect to the estimate."""
    from ditsep_tpu_torch.training import auraloss

    ref = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 2, 16)).astype(np.float32))
    ref[:2] *= 3.0
    est = ref.clone()
    est[2:] = ref[2:, [1, 0]]
    (est_r, ref_r) = dry.rank_rows(mesh, est.numpy(), ref.numpy())
    est_r.requires_grad_(True)
    with parallel.sharded(mesh):
        loss = auraloss.pit_min(auraloss.l1_loss, est_r, ref_r)
    (g,) = torch.autograd.grad(loss, est_r)
    g = parallel.all_gather_rows(g.numpy(), mesh) / (
        1 if mesh is None else mesh.world_size)
    return float(parallel.all_reduce_mean_(loss.detach(), mesh)), g


def gan_cases_worker(mesh, out, cases: bytes):
    """``ldm_steps`` / ``vaegan_steps`` of the arguments in ``cases`` (by
    family, pickled: see test_torch_parallel.cases_worker), rank 0's
    results saved to ``out``."""
    import pickle
    torch.set_num_threads(2)
    steps = {"ldm": ldm_steps, "vaegan": vaegan_steps}
    res = {k: steps[k](mesh, *args)
           for k, args in pickle.loads(cases).items()}
    if mesh.rank == 0:
        torch.save(res, out)


def _worker(mesh, out, draws):
    torch.set_num_threads(2)
    res = {"ldm": ldm_case(mesh), "vaegan": vaegan_case(mesh, draws),
           "refusal": normalized_fm_refusal(mesh), "pit": pit_case(mesh)}
    if mesh.rank == 0:
        torch.save(res, out)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("gan") / "two.pt"
    draws = vaegan_draws()
    run_ranks(_worker, str(out), draws)
    return draws, torch.load(out, weights_only=False)


@pytest.mark.parametrize("family", ["ldm", "vaegan"])
@pytest.mark.parametrize("step", ["gen", "disc"])
def test_gan_steps_over_two_ranks_match_one_process(two_ranks, family,
                                                     step):
    draws, two = two_ranks
    one = ldm_case(None) if family == "ldm" else vaegan_case(None, draws)
    got, want = two[family][step], one[step]
    check_grads(got["grads"], want["grads"], f"{family} {step}")
    check_step(got, want, want["grads"], one["rates"][step],
               one["decay"][step], f"{family} {step}")


def test_normalize_losses_refuses_a_shard(two_ranks):
    _, two = two_ranks
    assert "whole-batch mean" in two["refusal"]
    # one process (no shard) still computes it
    assert normalized_fm_refusal(None) == ""


def test_pit_min_takes_the_global_permutation(two_ranks):
    """Over two ranks ``pit_min`` is the global batch's: the same loss and
    gradient as one process, though rank 1's rows alone would take the
    other permutation."""
    _, two = two_ranks
    loss, grad = pit_case(None)
    assert abs(two["pit"][0] - loss) <= 1e-6 * loss
    np.testing.assert_allclose(two["pit"][1], grad, rtol=0, atol=1e-7)
    assert np.abs(grad[2:]).max() > 0  # rank 1's rows are not at their min
