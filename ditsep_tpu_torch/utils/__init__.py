"""Host-side helpers of the PyTorch port."""
from ditsep_tpu_torch.utils.device import resolve_device  # noqa: F401
