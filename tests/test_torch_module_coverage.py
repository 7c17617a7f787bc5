"""The port is complete: every ``.py`` of the JAX package, listed by path
(nothing of it imported), has a counterpart at the same path under
``ditsep_tpu_torch/``; the Pallas kernels' module
``ops/pallas_kernels.py`` maps to the CUDA kernels' ``ops/cuda_kernels.py``."""
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
RENAMED = {"ops/pallas_kernels.py": "ops/cuda_kernels.py"}
JAX_FILES = sorted(p.relative_to(REPO / "ditsep_tpu").as_posix()
                   for p in (REPO / "ditsep_tpu").rglob("*.py")
                   if "__pycache__" not in p.parts)


def test_the_jax_package_is_listed():
    assert len(JAX_FILES) > 100
    assert {"models/facodec.py", "native.py", "ops/pallas_kernels.py",
            "utils/hub.py"} <= set(JAX_FILES)


@pytest.mark.parametrize("path", JAX_FILES)
def test_counterpart_in_the_port(path):
    assert (REPO / "ditsep_tpu_torch" / RENAMED.get(path, path)).is_file()
