"""Separation driver of the PyTorch port, mirroring ditsep_tpu.training."""
from ditsep_tpu_torch.training.diffsep import (  # noqa: F401
    DiffSepConfig, DiffSepTrainer,
)
