"""Data IO and datasets of the PyTorch port."""
from ditsep_tpu_torch.data.audio import read_wav, write_wav  # noqa: F401
from ditsep_tpu_torch.data.latent_ds import (  # noqa: F401
    LatentDataset, save_latent_cache, save_latent_metadata,
)
from ditsep_tpu_torch.data.vctk_demand import NoisyDataset  # noqa: F401
from ditsep_tpu_torch.data.wsj0_mix import (  # noqa: F401
    BucketedLoader, SyntheticMixDataset, WSJ0Mix, length_buckets,
    max_collator,
)
