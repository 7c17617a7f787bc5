"""Inference: long-form chunked separation, the stable-audio samplers and
conditional generation."""
from ditsep_tpu_torch.inference.diffusion_prior import stereoize  # noqa: F401
from ditsep_tpu_torch.inference.generation import (  # noqa: F401
    build_mask, generate_diffusion_cond, initial_noise,
)
from ditsep_tpu_torch.inference.longform import (  # noqa: F401
    align_permutation,
    separate_longform,
)
from ditsep_tpu_torch.inference.sampling import (  # noqa: F401
    alpha_sigma_to_t,
    distribution_shift_time,
    get_alphas_sigmas,
    get_bmask,
    karras_sigmas,
    sample,
    sample_discrete_euler,
    sample_flow_dpmpp,
    sample_k,
    sample_rf,
    sample_rk4,
    truncated_logistic_normal_rescaled,
)
