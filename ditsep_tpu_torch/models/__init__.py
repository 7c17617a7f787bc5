"""Models of the PyTorch port, mirroring ditsep_tpu.models."""
from ditsep_tpu_torch.models.ncsnpp import NCSNpp  # noqa: F401
from ditsep_tpu_torch.models.score_models import ScoreModelNCSNpp  # noqa: F401
from ditsep_tpu_torch.models.weights import (  # noqa: F401
    load_params_npz, params_from_jax, params_to_jax, save_params_npz,
)
