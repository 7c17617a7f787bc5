"""SDEs and samplers of the PyTorch port, mirroring ditsep_tpu.sdes."""
from ditsep_tpu_torch.sdes.core import (  # noqa: F401
    BaseSDE, MixSDE, MixStd, SDERegistry, bcast_right, mix_mult,
    mix_mult_inv,
)
from ditsep_tpu_torch.sdes.correctors import (  # noqa: F401
    CorrectorRegistry, ald2_corrector,
)
from ditsep_tpu_torch.sdes.predictors import (  # noqa: F401
    PredictorRegistry, reverse_diffusion_predictor,
)
from ditsep_tpu_torch.sdes.samplers import pc_sample  # noqa: F401
