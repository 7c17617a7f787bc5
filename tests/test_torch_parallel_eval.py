"""Evaluation and serving over a mesh, on the CPU.

* ``evaluate_dataset`` on 5 items over two gloo ranks writes the same
  results and summary JSONs as one process at the same effective batch
  (every number within 1e-6 abs, ``runtime`` aside), the PC sampler's
  draws the whole batch's; its chunk layout (padded length, real items,
  items a call) equals JAX's ``evaluate_dataset`` on a 2-device CPU mesh,
  run in a subprocess.
* ``BatchingEngine(mesh=)`` over two CPU devices: its batch sizes and
  padded rows equal JAX's engine on a 2-device mesh, and its stems the
  plain engine's (1e-6 of max|ref|), each replica drawing its rows of
  the whole batch's draws.

No JAX import at the top: the spawned ranks import this module.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.data import SyntheticMixDataset
from ditsep_tpu_torch.eval import evaluate_dataset
from ditsep_tpu_torch.scripts import dryrun_multichip as dry
from test_torch_parallel import run_ranks

REPO = Path(__file__).resolve().parents[1]
N_ITEMS, ITEM_S, BATCH = 5, 0.5, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def evaluate(mesh, out_dir):
    """The dryrun's tiny waveform trainer's PC sampler (N=2) over the
    items, as cli.evaluate drives it."""
    trainer = dry.diffsep_trainer("cpu")

    def sep(mix, lengths=None, generator=None):
        return trainer.separate(mix, N=2, generator=generator)[0]

    ds = SyntheticMixDataset(n_items=N_ITEMS, min_len_s=ITEM_S,
                             max_len_s=ITEM_S)
    res = evaluate_dataset(sep, ds, fs=8000, batch_size=BATCH, nfe=4,
                           warmup=True, device="cpu", mesh=mesh,
                           out_dir=out_dir)
    return {k: res[k] for k in ("results", "summary", "chunks", "calls")}


def _eval_worker(mesh, out_dir, out):
    torch.set_num_threads(2)
    res = evaluate(mesh, out_dir if mesh.rank == 0 else None)
    torch.save(res, f"{out}.{mesh.rank}")


def _numbers_close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "runtime":
                _numbers_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _numbers_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def two_rank_eval(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    run_ranks(_eval_worker, str(tmp / "two"), str(tmp / "res"))
    return tmp, [torch.load(f"{tmp / 'res'}.{r}", weights_only=False)
                 for r in range(2)]


def test_evaluate_dataset_over_two_ranks_writes_the_one_process_jsons(
        two_rank_eval, tmp_path):
    tmp, ranks = two_rank_eval
    one = evaluate(None, str(tmp_path / "one"))
    # every rank returns rank 0's results; the layout is one process's
    # at the same effective batch (2 = ceil(2 / 2) * 2)
    for res in ranks:
        assert res["chunks"] == one["chunks"] == [(4096, 2, 2), (4096, 2, 2),
                                                  (4096, 1, 2)]
        assert res["calls"] == one["calls"] == 4
        _numbers_close(res["results"], one["results"])
    for name in ("test.json", "test_summary.json"):
        got = json.loads((tmp / "two" / name).read_text())
        want = json.loads((tmp_path / "one" / name).read_text())
        _numbers_close(got, want, name)
    assert len(json.loads((tmp / "two" / "test.json").read_text())) \
        == N_ITEMS


JAX_LAYOUT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from ditsep_tpu.data.wsj0_mix import SyntheticMixDataset
    from ditsep_tpu.eval.evaluate import evaluate_dataset
    from ditsep_tpu.parallel import make_mesh

    class Recorded(SyntheticMixDataset):
        fetched = []
        def __getitem__(self, i):
            self.fetched.append(int(i))
            return super().__getitem__(i)

    ds = Recorded(n_items={n}, min_len_s={s}, max_len_s={s})
    chunks = []

    def sep(key, mix):
        chunks.append([int(mix.shape[-1]), len(set(ds.fetched)),
                       int(mix.shape[0])])
        ds.fetched.clear()
        return jnp.concatenate([mix, mix], axis=1)

    mesh = make_mesh()
    assert mesh.devices.size == 2
    evaluate_dataset(sep, ds, fs=8000, batch_size={b}, nfe=4, mesh=mesh,
                     warmup=False, metric_workers=1)
    print(json.dumps(chunks))
""")


def test_evaluate_chunk_layout_matches_jax_on_a_two_device_mesh(
        two_rank_eval):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", JAX_LAYOUT.format(n=N_ITEMS, s=ITEM_S,
                                                 b=BATCH)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = [tuple(c) for c in json.loads(out.stdout.strip().splitlines()[-1])]
    _, ranks = two_rank_eval
    assert [tuple(c) for c in ranks[0]["chunks"]] == want


def test_evaluate_refuses_several_local_devices():
    """One device a process: a mesh of two local devices (the serving
    engine's) is refused, not run on its first device."""
    ds = SyntheticMixDataset(n_items=1, min_len_s=ITEM_S, max_len_s=ITEM_S)
    with pytest.raises(ValueError, match="one device a process"):
        evaluate_dataset(_port_pointwise, ds, device="cpu",
                         mesh=parallel.make_mesh(device=["cpu", "cpu"]))


# -- serving ---------------------------------------------------------------
def _jax_pointwise(key, mix, *args):
    x = np.asarray(mix)[:, 0]
    return np.stack([2.0 * x, -x], axis=1)


def _port_pointwise(mix, lengths=None, generator=None):
    x = mix[:, 0]
    return torch.stack([2.0 * x, -x], dim=1)


class _Pointwise:
    def __call__(self, mix, lengths=None, generator=None):
        return _port_pointwise(mix, lengths, generator)

    def replicate(self, device):
        return _Pointwise()


@pytest.mark.parametrize("max_batch", [1, 3, 4, 5, 8])
def test_engine_batch_sizes_and_padding_match_jax_on_two_devices(max_batch):
    import jax
    from ditsep_tpu.parallel import make_mesh as jax_mesh
    from ditsep_tpu.serving import BatchingEngine as JaxEngine
    from ditsep_tpu_torch.serving import BatchingEngine

    mesh = parallel.make_mesh(device=["cpu", "cpu"])
    kw = dict(max_batch=max_batch, max_wait_ms=20.0)
    engines = (JaxEngine(_jax_pointwise, mesh=jax_mesh(n_data=2), **kw),
               BatchingEngine(_Pointwise(), mesh=mesh, device="cpu", **kw))
    stats = []
    for eng in engines:
        try:
            futs = [eng.submit(np.full(4000, i + 1.0, np.float32))
                    for i in range(3)]
            for i, f in enumerate(futs):
                out = f.result(timeout=60)
                np.testing.assert_array_equal(out[1], -(i + 1.0))
            stats.append((eng.batch_sizes,
                          {k: eng.stats()[k] for k in
                           ("batches", "batched_items", "padded_rows")}))
        finally:
            eng.close()
    assert stats[0] == stats[1]
    assert all(b % 2 == 0 for b in stats[1][0])
    assert jax.device_count() >= 2


def test_engine_over_two_devices_gives_the_plain_engines_stems():
    """Three requests of one bucket (a padded row) through the tiny
    waveform trainer's PC sampler: the mesh engine splits the batch of 4
    over two replicas, each drawing its rows of the batch's draws."""
    from ditsep_tpu_torch.cli.serve_api import TrainerSeparator
    from ditsep_tpu_torch.serving import BatchingEngine

    trainer = dry.diffsep_trainer("cpu")
    rng = np.random.default_rng(9)
    audios = [rng.standard_normal(n).astype(np.float32)
              for n in (3000, 3500, 4000)]
    outs = []
    for mesh in (None, parallel.make_mesh(device=["cpu", "cpu"])):
        eng = BatchingEngine(
            TrainerSeparator(trainer, latent=False, N=2, sampler="pc"),
            max_batch=4, max_wait_ms=200.0, device="cpu", mesh=mesh,
            seed=3)
        try:
            futs = [eng.submit(a) for a in audios]
            outs.append([f.result(timeout=60) for f in futs])
            assert eng.stats()["padded_rows"] == 1
        finally:
            eng.close()
    for want, got in zip(*outs):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_engine_on_a_mesh_of_one_device_is_the_plain_engine():
    """A mesh of one device: the plain engine's batch sizes and its stems
    bit for bit (no replica, one call on the whole batch)."""
    from ditsep_tpu_torch.cli.serve_api import TrainerSeparator
    from ditsep_tpu_torch.serving import BatchingEngine

    trainer = dry.diffsep_trainer("cpu")
    audio = np.random.default_rng(10).standard_normal(3000).astype(
        np.float32)
    outs, sizes = [], []
    for mesh in (None, parallel.make_mesh(device="cpu")):
        eng = BatchingEngine(
            TrainerSeparator(trainer, latent=False, N=2, sampler="pc"),
            max_batch=4, max_wait_ms=1.0, device="cpu", mesh=mesh, seed=3)
        try:
            outs.append(eng.separate(audio, timeout=60))
            sizes.append(eng.batch_sizes)
        finally:
            eng.close()
    assert sizes[0] == sizes[1] == [1, 2, 4]
    assert outs[0].tobytes() == outs[1].tobytes()
