"""The port's data parallelism (ditsep_tpu_torch.parallel) on the CPU.

``make_mesh``'s shape checks; ``pad_batch_to_devices`` and ``shard_batch``
against the JAX package's on the same numpy arrays (bits equal); the
launcher (a lost rank fails the run fast); and one train step of the
waveform and the latent trainer over two gloo ranks, a batch of 4 split
2 + 2 with the draws passed in, against the one-process step on the 4.

Tolerances (tests/test_torch_train_step.py's bars, stated before the
runs): the loss and the grad norm 1e-4 relative; each gradient leaf
within 1e-3 of its max; the parameters within 1e-3 * lr where the
gradient is at least 1e-3 of its leaf's max, 2 * lr elsewhere (Adam's
first step moves a near-zero gradient by up to lr, of either sign); the
EMA within those bars times (1 - decay) plus 2 float32 ulps. Spawned
ranks run under a join timeout and a rendezvous timeout, on a free port
each.

No JAX import at the top: the spawned ranks import this module.
"""
import numpy as np
import pytest
import torch

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.scripts import dryrun_multichip as dry
from ditsep_tpu_torch.utils.separate import normalize_batch

RANK_TIMEOUT_S = 120.0
B = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_ranks(fn, *args, nproc=2):
    """``fn(mesh, *args)`` on ``nproc`` gloo ranks on the CPU."""
    parallel.launch(fn, nproc, *args, device="cpu", backend="gloo",
                    timeout_s=RANK_TIMEOUT_S)


# -- bars ---------------------------------------------------------------------
def check_grads(got, want, what):
    """Each leaf within 1e-3 of its max; a leaf of round-off gradient (its
    max under 1e-6 of the largest leaf's: an exact gradient of 0) within
    1e-6 of the largest leaf's max, as tests/test_torch_train_step.py's
    significance rule."""
    assert set(got) == set(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        leaf = float(np.abs(w).max())
        bar = 1e-3 * leaf if leaf >= 1e-6 * top else 1e-6 * top
        assert err <= bar, (what, k, err, bar)


def check_step(got, want, grads, lr, decay, what):
    """The train-step bars after one step: ``got`` / ``want`` hold "metrics",
    "state" and "ema" (float arrays by state-dict key); ``grads`` the
    one-process gradient by parameter name."""
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= 1e-4 * abs(w) + 1e-12, (what, k)
    top = max(float(np.abs(g).max()) for g in grads.values())
    for k, w in want["state"].items():
        if k in grads:
            g = np.abs(grads[k])
            sig = (g >= 1e-3 * g.max()) & (g.max() >= 1e-6 * top)
            bar = np.where(sig, 1e-3 * lr, 2 * lr)
        else:  # a buffer does not move
            bar = 1e-9
        err = np.abs(got["state"][k] - w)
        assert (err <= bar).all(), (what, k, float(err.max()))
        e = want["ema"][k]
        slack = 2 * np.spacing(np.abs(e).astype(np.float32))
        err = np.abs(got["ema"][k] - e)
        assert (err <= bar * (1 - decay) + slack).all(), (what, k)


# -- mesh and batch helpers ---------------------------------------------------
def test_make_mesh_shapes_and_checks():
    m = parallel.make_mesh(device=["cpu", "cpu"])
    assert m.devices.shape == (2,) and m.devices.size == 2
    assert (m.rank, m.world_size, m.group) == (0, 1, None)
    m = parallel.make_mesh(device=["cpu"] * 4, n_data=3)
    assert m.devices.size == 3 and len(m.local) == 3
    m = parallel.make_mesh(device=["cpu"] * 4, axis_names=("data", "model"))
    assert m.devices.shape == (4, 1) and m.axis_names == ("data", "model")
    m = parallel.make_mesh(device=["cpu"] * 4, axis_names=("data", "model"),
                           shape=(2, 1))
    assert m.devices.shape == (2, 1)
    with pytest.raises(ValueError, match="does not match"):
        parallel.make_mesh(device=["cpu"] * 4, shape=(2, 1))
    with pytest.raises(ValueError, match="needs 8 devices"):
        parallel.make_mesh(device=["cpu"] * 4, axis_names=("data",),
                           shape=(8,))
    with pytest.raises(NotImplementedError, match="first"):
        parallel.make_mesh(device=["cpu"] * 4, axis_names=("data", "model"),
                           shape=(2, 2))
    assert parallel.make_mesh(device="cpu").devices.size == 1
    assert parallel.is_rank_zero()


def test_initialize_multihost_is_a_noop_without_a_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    parallel.initialize_multihost(device="cpu")
    parallel.initialize_multihost(None, 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("b", [1, 4, 5, 7])
def test_pad_batch_to_devices_matches_jax(b):
    from ditsep_tpu.parallel import pad_batch_to_devices as jax_pad

    rng = np.random.default_rng(b)
    batch = (rng.standard_normal((b, 1, 6)).astype(np.float32),
             {"t": rng.standard_normal((b, 2, 6)).astype(np.float32)})
    want, n_want = jax_pad(batch, 4)
    got, n_got = parallel.pad_batch_to_devices(batch, 4)
    assert n_got == n_want == b
    assert got[0].tobytes() == np.asarray(want[0]).tobytes()
    assert got[1]["t"].tobytes() == np.asarray(want[1]["t"]).tobytes()
    tgot, _ = parallel.pad_batch_to_devices(torch.from_numpy(batch[0]), 4)
    assert tgot.numpy().tobytes() == np.asarray(want[0]).tobytes()


def test_shard_batch_rows_match_jax_shards():
    """Each rank's rows are the rows JAX's shard_batch puts on the mesh's
    device of the same index, bit for bit; a batch that does not split
    raises, as JAX's sharding does."""
    import jax
    from ditsep_tpu.parallel import make_mesh as jax_mesh
    from ditsep_tpu.parallel import shard_batch as jax_shard

    x = np.random.default_rng(0).standard_normal((4, 2, 3)).astype(
        np.float32)
    jm = jax_mesh(n_data=2)
    shards = {s.device: np.asarray(s.data) for s in
              jax_shard(jm, x).addressable_shards}
    for rank in range(2):
        mesh = parallel.Mesh(devices=np.array(["cpu", "cpu"], object),
                             axis_names=("data",), group=None, rank=rank,
                             world_size=2, local=(torch.device("cpu"),))
        got = parallel.shard_batch(mesh, (x,))[0].numpy()
        assert got.tobytes() == shards[jm.devices[rank]].tobytes()
        with pytest.raises(ValueError, match="does not split"):
            parallel.shard_batch(mesh, (x[:3],))
    with pytest.raises(Exception):
        jax.device_put(x[:3], jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec("data")))


def _lost_rank(mesh):
    if mesh.rank == 1:
        raise SystemExit(3)
    parallel.all_reduce_mean_(torch.ones(1), mesh)


def test_launch_fails_fast_when_a_rank_is_lost():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks failed"):
        run_ranks(_lost_rank)
    assert time.monotonic() - t0 < 60


# -- the train steps over two ranks ------------------------------------------
def waveform_draws(cfg, b, shape, seed):
    """The raw draws of ``training_loss`` under init hack 5 (the shuffled
    score loss and the t=T PIT loss) for a (b, 2, *shape) target."""
    assert cfg.init_hack == 5 and cfg.time_sampling_strategy == "uniform"
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return {"time_u": f(rng.uniform(size=b)),
            "z": f(rng.standard_normal((b, 2, *shape))),
            "shuffle_u": f(rng.uniform(size=(b, 2))),
            "mask_u": f(rng.uniform(size=b)),
            "pit_z": f(rng.standard_normal((b, 2, *shape)))}


def _grads(model, loss_fn, mesh):
    params = dict(model.named_parameters())
    with torch.enable_grad(), parallel.sharded(mesh):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    parallel.all_reduce_grads_(grads, mesh)
    return {k: g.cpu().numpy() for k, g in zip(params, grads)}


def step_case(mesh, trainer, batch, draws, device="cpu"):
    """The gradient and one train step of ``trainer`` (a waveform or a
    latent trainer) on the global ``batch`` (numpy (mix, tgt); this
    rank's rows with ``mesh``) with the global batch's ``draws``, on
    ``device`` (the mesh's)."""
    device = device if mesh is None else mesh.device
    rows = dry.rank_rows(mesh, *batch, device=device)
    if hasattr(trainer, "train_step_latent"):
        def loss():
            return trainer.training_loss_latent(trainer.model, *rows,
                                                draws=draws)
        step = trainer.train_step_latent
    else:
        (m, t), _, _ = normalize_batch(rows)

        def loss():
            return trainer.training_loss(trainer.model, m, t, draws=draws)
        step = trainer.train_step
    grads = _grads(trainer.model, loss, mesh)
    state, metrics = step(trainer.init_state(), rows, draws=draws, mesh=mesh)
    return {"grads": grads, "metrics": dry.scalars(metrics),
            "state": dry.float_state(state.model.state_dict()),
            "ema": dry.float_state(state.ema.state_dict()),
            "lr": trainer.cfg.lr, "decay": trainer.cfg.ema_decay}


def diffsep_case(mesh, draws, device="cpu"):
    """``step_case`` of the dryrun's waveform trainer on its global batch
    of 4."""
    device = device if mesh is None else mesh.device
    return step_case(mesh, dry.diffsep_trainer(device),
                     dry.waveform_batch(B, 2048, seed=0), draws, device)


def latent_case(mesh, draws):
    """The same for the dryrun's latent trainer (the posterior draws
    too)."""
    return step_case(mesh, dry.latent_trainer("cpu"),
                     dry.waveform_batch(B, 512, seed=1), draws)


def cases_worker(mesh, out, cases: bytes):
    """``step_case`` of each (trainer, batch, draws) in ``cases``, rank 0's
    results saved to ``out``. ``cases`` comes pickled: a tensor handed to
    a rank as it is would share its memory with the parent and the other
    ranks (torch.multiprocessing), and each rank's step would update the
    same parameters."""
    import pickle
    torch.set_num_threads(2)
    res = {k: step_case(mesh, *case)
           for k, case in pickle.loads(cases).items()}
    if mesh.rank == 0:
        torch.save(res, out)


def all_draws():
    cfg = dry.diffsep_trainer("cpu").cfg
    lt = dry.latent_trainer("cpu")
    d, tl = lt.vae.latent_dim, 512 // lt.vae.downsampling_ratio
    latent = waveform_draws(lt.cfg, B, (d, tl), seed=11)
    rng = np.random.default_rng(12)
    latent["enc_mix_z"] = rng.standard_normal((B, d, tl)).astype(np.float32)
    latent["enc_tgt_z"] = rng.standard_normal((2 * B, d, tl)).astype(
        np.float32)
    return {"diffsep": waveform_draws(cfg, B, (2048,), seed=10),
            "latent": latent}


def _steps_worker(mesh, out, draws):
    torch.set_num_threads(2)
    res = {"diffsep": diffsep_case(mesh, draws["diffsep"]),
           "latent": latent_case(mesh, draws["latent"])}
    if mesh.rank == 0:
        torch.save(res, out)


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps") / "two.pt"
    draws = all_draws()
    run_ranks(_steps_worker, str(out), draws)
    return draws, torch.load(out, weights_only=False)


@pytest.mark.parametrize("family", ["diffsep", "latent"])
def test_train_step_over_two_ranks_matches_one_process(two_rank_steps,
                                                        family):
    draws, two = two_rank_steps
    case = {"diffsep": diffsep_case, "latent": latent_case}[family]
    one = case(None, draws[family])
    check_grads(two[family]["grads"], one["grads"], family)
    check_step(two[family], one, one["grads"], one["lr"], one["decay"],
               family)
    assert two[family]["metrics"]["train/score_loss"] > 0
