"""ROADMAP C2 at the flagship's width: the port's bf16 score forward is
as far from its f32 forward as the JAX package's (tests/test_torch_bf16.py's
bars: 0.5-1.5x JAX's max|bf16 - f32| / max|f32| at each time, the f32
forwards within 1e-4 of max|ref|) at nf=128 and the flagship's depth, on
chip_smoke.py's witness inputs (``bf16_witness_inputs``: batch 1, 4,000
samples, seeded); and JAX's distances there are the ones chip_smoke.py
records (``BF16_WITNESS_JAX``, within 2% each) and holds the card's
forward to, at the same 0.5-1.5x."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_bf16 import _distance, _models, _outputs

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_module", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship_models():
    return _models({"model.score_model.nf": 128})


@pytest.mark.parametrize("i", range(len(chip_smoke.BF16_WITNESS_T)))
def test_flagship_bf16_witness_is_the_one_chip_smoke_holds(flagship_models,
                                                           i):
    t = chip_smoke.BF16_WITNESS_T[i]
    got, want = _outputs(flagship_models, t, chip_smoke.bf16_witness_inputs())
    peak = np.abs(want["f32"]).max()
    assert np.abs(got["f32"] - want["f32"]).max() <= 1e-4 * peak
    recorded = chip_smoke.BF16_WITNESS_JAX[i]
    assert abs(_distance(want) - recorded) <= 0.02 * recorded
    lo, hi = chip_smoke.BF16_WITNESS_RATIO
    assert lo * _distance(want) <= _distance(got) <= hi * _distance(want)
