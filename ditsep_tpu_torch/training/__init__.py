"""Training and separation of the PyTorch port, mirroring
ditsep_tpu.training."""
from ditsep_tpu_torch.training.diffsep import (  # noqa: F401
    ClipAdam, DiffSepConfig, DiffSepTrainer, TrainState,
)
