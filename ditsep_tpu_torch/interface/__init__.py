"""Demo interface: the separation, autoencoder, generation and token-LM
backends (app), the stdlib web server and the gradio shell (gated on
gradio)."""
from ditsep_tpu_torch.interface.app import (  # noqa: F401
    AutoencoderApp, GenerationApp, LMApp, SeparationApp, spectrogram_preview,
)
from ditsep_tpu_torch.interface.gradio_ui import create_ui  # noqa: F401
from ditsep_tpu_torch.interface.web import (  # noqa: F401
    DemoServer, decode_wav, encode_wav,
)

__all__ = ["AutoencoderApp", "DemoServer", "GenerationApp", "LMApp",
           "SeparationApp", "create_ui", "decode_wav", "encode_wav",
           "spectrogram_preview"]
