"""Print the measured errors of the port against the JAX package on the CPU,
one JSON line per comparison, at the inputs of tests/test_torch_*.py.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

The tests assert the tolerances; this script reports how far inside them
each comparison lands (the parity table of PERF.md).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_ncsnpp as tn  # noqa: E402
import test_torch_score_model as ts  # noqa: E402
import test_torch_separate as tsep  # noqa: E402
from ditsep_tpu.ops import fir as jfir  # noqa: E402
from ditsep_tpu.ops import stft as jstft  # noqa: E402
from ditsep_tpu.ops.pallas_kernels import downsample_2d_pallas  # noqa: E402
from ditsep_tpu.ops.stft import istft as jistft  # noqa: E402
from ditsep_tpu_torch.models import ScoreModelNCSNpp, load_params_npz  # noqa: E402
from ditsep_tpu_torch.models import NCSNpp, params_from_jax  # noqa: E402
from ditsep_tpu_torch.ops import fir, istft, stft  # noqa: E402


def report(module, tolerance, got, want, relative):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    if relative:
        err /= float(np.abs(want).max())
    print(json.dumps({"module": module, "tolerance": tolerance,
                      "max_err": err, "relative_to_max_ref": relative}))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def main():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    k = [1, 2, 3, 4]
    report("ops.fir.upsample_2d", "1e-5 abs",
           nhwc(fir.upsample_2d(xt, k, 2, 2.5)),
           jfir.upsample_2d(jnp.asarray(x), k, 2, 2.5), False)
    report("ops.fir.downsample_2d (plain)", "1e-5 abs",
           nhwc(fir.downsample_2d(xt, k, 2, 2.5)),
           jfir.downsample_2d(jnp.asarray(x), k, 2, 2.5), False)
    report("ops.fir.downsample_2d vs downsample_2d_pallas", "1e-5 abs",
           nhwc(fir.downsample_2d(xt, k, 2, 2.5)),
           downsample_2d_pallas(jnp.asarray(x), k, 2, 2.5), False)
    w = np.random.default_rng(6).standard_normal((2, 3, 1000)).astype(
        np.float32)
    spec = np.array(jstft(jnp.asarray(w)))
    report("ops.stft", "1e-5 * max|ref|", stft(torch.from_numpy(w)).numpy(),
           spec, True)
    exact = torch.stft(
        torch.from_numpy(w.astype(np.float64)).reshape(-1, 1000), 510, 128,
        510, torch.hann_window(510, dtype=torch.float64), center=True,
        pad_mode="constant", return_complex=True).reshape(spec.shape)
    report("ops.stft vs float64", "1e-5 abs",
           stft(torch.from_numpy(w)).numpy(), exact.numpy(), False)
    report("ditsep_tpu.ops.stft (JAX) vs float64", "reference only", spec,
           exact.numpy(), False)
    report("ops.istft (length 1000)", "1e-5 abs",
           istft(torch.from_numpy(spec), length=1000).numpy(),
           jistft(jnp.asarray(spec), length=1000), False)

    jm, params, flat = tn._jax_model_and_params(True)
    xn = np.random.default_rng(1).standard_normal((2, 32, 16, 6)).astype(
        np.float32)
    tc = np.array([0.3, 0.8], np.float32)
    model = NCSNpp(**tn.CFG).eval()
    model.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        got = nhwc(model(torch.from_numpy(xn).permute(0, 3, 1, 2)
                         .contiguous(), torch.from_numpy(tc)))
    report("models.ncsnpp.NCSNpp (nf=16, perturbed JAX init)",
           "2e-5 * max|ref|", got,
           jax.jit(jm.apply)({"params": params}, jnp.asarray(xn),
                             jnp.asarray(tc)), True)

    apply, jparams = ts.load_jax_side()
    port = load_params_npz(ts.CKPT, ScoreModelNCSNpp(**ts.CFG)).eval()
    r = np.random.default_rng(2000)
    xs = r.standard_normal((2, 2, 2000)).astype(np.float32)
    mix = r.standard_normal((2, 1, 2000)).astype(np.float32)
    tt = np.array([0.5, 0.1], np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(xs), torch.from_numpy(tt),
                   torch.from_numpy(mix)).numpy()
    report("models.score_models.ScoreModelNCSNpp (masked_synthetic_ema)",
           "1e-4 * max|ref|", got,
           apply({"params": jparams}, jnp.asarray(xs), jnp.asarray(tt),
                 jnp.asarray(mix)), True)

    b, length, n = 2, 1500, 3
    jt, sparams, tt_ = tsep._tiny_pair(length)
    r = np.random.default_rng(3)
    mix = (0.1 * r.standard_normal((b, 1, length))).astype(np.float32)
    noise = (r.standard_normal((b, 2, length)).astype(np.float32),
             r.standard_normal((n, 1, b, 2, length)).astype(np.float32),
             r.standard_normal((n, b, 2, length)).astype(np.float32))
    want, _ = jt.separate(sparams, jax.random.PRNGKey(0), jnp.asarray(mix),
                          N=n, noise=noise)
    got, _ = tt_.separate(torch.from_numpy(mix), N=n, noise=noise)
    report("training.diffsep.DiffSepTrainer.separate (nf=16, N=3)",
           "1e-3 * max|ref|", got.numpy(), want, True)


if __name__ == "__main__":
    main()
