"""Data IO of the PyTorch port."""
from ditsep_tpu_torch.data.audio import read_wav, write_wav  # noqa: F401
