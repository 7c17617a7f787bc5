"""Ops of the PyTorch port (NCHW), mirroring ditsep_tpu.ops."""
from ditsep_tpu_torch.ops.conv3x3 import (  # noqa: F401
    conv3x3_bordered, conv3x3_bordered_async,
)
from ditsep_tpu_torch.ops.fir import (  # noqa: F401
    downsample_2d, naive_downsample_2d, naive_upsample_2d, upsample_2d,
)
from ditsep_tpu_torch.ops.fused_act import fused_leaky_relu  # noqa: F401
from ditsep_tpu_torch.ops.stft import istft, n_frames_prepadded, stft  # noqa: F401
from ditsep_tpu_torch.ops.upfirdn2d import setup_fir_kernel, upfirdn2d  # noqa: F401
