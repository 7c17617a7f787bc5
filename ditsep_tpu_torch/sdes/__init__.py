"""SDEs and samplers of the PyTorch port, mirroring ditsep_tpu.sdes."""
from ditsep_tpu_torch.sdes.core import (  # noqa: F401
    OUVESDE, SBVESDE, BaseSDE, MixSDE, MixStd, PriorMixSDE, PriorMixStd,
    SDERegistry, bcast_right, mix_mult, mix_mult_inv,
)
from ditsep_tpu_torch.sdes.correctors import (  # noqa: F401
    CorrectorRegistry, ald2_corrector, ald_corrector, langevin_corrector,
)
from ditsep_tpu_torch.sdes.predictors import (  # noqa: F401
    PredictorRegistry, euler_maruyama_predictor,
    reverse_diffusion_predictor,
)
from ditsep_tpu_torch.sdes.samplers import (  # noqa: F401
    ab2_sample, ode_sample, ode_sample_scipy, pc_sample, sb_sample,
)

__all__ = [
    "BaseSDE",
    "MixSDE",
    "MixStd",
    "OUVESDE",
    "PriorMixSDE",
    "PriorMixStd",
    "SBVESDE",
    "SDERegistry",
    "CorrectorRegistry",
    "PredictorRegistry",
    "bcast_right",
    "pc_sample",
    "ab2_sample",
    "ode_sample",
    "ode_sample_scipy",
    "sb_sample",
]
