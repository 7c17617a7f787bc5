"""Models of the PyTorch port, mirroring ditsep_tpu.models."""
from ditsep_tpu_torch.models.layers import (  # noqa: F401
    Downsample, ResampleConv2d, ResnetBlockBigGANpp, ResnetBlockDDPMpp,
    Upsample,
)
from ditsep_tpu_torch.models.ncsnpp import NCSNpp  # noqa: F401
from ditsep_tpu_torch.models.oobleck import OobleckVAE  # noqa: F401
from ditsep_tpu_torch.models.score_models import (  # noqa: F401
    LatentScoreModelNCSNpp, ScoreModelNCSNpp,
)
from ditsep_tpu_torch.models.sepformer import (  # noqa: F401
    SepFormer, sepformer_params_from_torch,
)
from ditsep_tpu_torch.models.torch_import import (  # noqa: F401
    dau1d_reference_state, diffsep_ema_param_order, dit_reference_state,
    import_dau1d_params, import_diffsep_ema, import_dit_params,
    import_ema_params, import_oobleck_params, import_params,
    load_torch_ckpt,
)
from ditsep_tpu_torch.models.weights import (  # noqa: F401
    disc_params_from_jax, disc_params_to_jax, load_params_npz,
    oobleck_params_from_jax, oobleck_params_to_jax, params_from_jax,
    params_to_jax, save_params_npz,
)
