"""Score an EMA ``.npz`` written by ``ditsep_tpu_torch.examples.
train_synthetic --save-params`` with the JAX package's own sampler on the
CPU: the same 8 held-out items (SyntheticMixDataset, seed 10,000), PC at
N=30 (``--N``) under ``jax.random.PRNGKey(1)``, the permutation-invariant
SI-SDR (zero mean, clamped at 30 dB), as examples/train_synthetic.py
evaluates. A check that weights trained by the port on the card separate
as well under the reference's sampler as under the port's.

    JAX_PLATFORMS=cpu python scripts/jax_score_npz.py ema.npz [--nf 32] \
        [--N 30]

About 5 minutes at nf=32 on 8 CPU cores. Prints one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ditsep_tpu.configs import (  # noqa: E402
    CONFIG_FAMILIES, build_diffsep_trainer, override,
)
from ditsep_tpu.data import SyntheticMixDataset, max_collator  # noqa: E402
from ditsep_tpu.training.losses import si_sdr_pit  # noqa: E402
from ditsep_tpu.utils.checkpoint import load_params_npz  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--nf", type=int, default=32)
    p.add_argument("--len-s", type=float, default=4.0)
    p.add_argument("--N", type=int, default=30)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    trainer = build_diffsep_trainer(override(CONFIG_FAMILIES["diffsep"](), {
        "model.score_model.nf": args.nf,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)}))
    ds = SyntheticMixDataset(n_items=8, min_len_s=args.len_s,
                             max_len_s=args.len_s, seed=10_000)
    mix, tgt = map(jnp.asarray, max_collator([ds[j] for j in range(8)]))
    shapes = jax.eval_shape(trainer.model.init, jax.random.PRNGKey(0),
                            tgt[:1], jnp.full((1,), 0.5), mix[:1])
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                            shapes["params"])
    params = {"params": load_params_npz(args.npz, template)}
    sep = jax.jit(lambda prm, key, m: trainer.separate(prm, key, m,
                                                       N=args.N)[0])
    t0 = time.time()
    est = sep(params, jax.random.PRNGKey(1), mix)

    def si(x):
        return float(jnp.mean(si_sdr_pit(x, tgt, zero_mean=True,
                                         clamp_db=30.0)))

    print(json.dumps({"npz": args.npz, "N": args.N,
                      "si_sdr_separated": round(si(est), 3),
                      "si_sdr_mixture_baseline": round(
                          si(jnp.broadcast_to(mix, tgt.shape)), 3),
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
