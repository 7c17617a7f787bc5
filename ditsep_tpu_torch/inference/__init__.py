"""Inference: long-form chunked separation."""
from ditsep_tpu_torch.inference.longform import (  # noqa: F401
    align_permutation,
    separate_longform,
)
