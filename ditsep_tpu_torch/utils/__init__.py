"""Host-side helpers of the PyTorch port: device selection, registries,
batch helpers, misc (the exports of ditsep_tpu/utils/__init__.py)."""
from ditsep_tpu_torch.utils.device import resolve_device  # noqa: F401
from ditsep_tpu_torch.utils.misc import (  # noqa: F401
    AutoClipper,
    SplitDirectory,
    StandardScaler,
    clip_update_by_threshold,
    count_parameters,
    solve_psd_loaded,
)
from ditsep_tpu_torch.utils.registry import Registry  # noqa: F401
from ditsep_tpu_torch.utils.separate import (  # noqa: F401
    denormalize_batch,
    normalize_batch,
    pad_to_hop,
    power_order_sources,
    select_elem_at_random,
    shuffle_sources,
)
