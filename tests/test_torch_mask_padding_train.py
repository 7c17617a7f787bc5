"""One train step of the port's masked score model (``mask_padding=True``,
the static mask, autograd through the plain masked GroupNorm) against the
JAX package's jitted ``train_step``, with JAX's own draws, at the bars of
tests/test_torch_train_step.py (a file of its own: JAX compiles the
masked train step for about 20 s).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_mask_padding import _masked_pair
from test_torch_train import _batch
from test_torch_train_step import _run


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_masked_train_step_matches_jax():
    length = 800
    jt, params, tt = _masked_pair(length, seed=3)
    assert tt.model.mask_padding
    rng = np.random.default_rng(11)
    mix, tgt = _batch(b=2, t_len=length, seed=12)
    mix = mix + 0.01 * rng.standard_normal(mix.shape).astype(np.float32)
    _run(jt, params, tt, [(mix, tgt)], [jax.random.PRNGKey(13)], jit=True)
