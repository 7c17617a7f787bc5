"""Demo interface: the separation, autoencoder, generation and token-LM
backends (app) and the stdlib web server."""
from ditsep_tpu_torch.interface.app import (  # noqa: F401
    AutoencoderApp, GenerationApp, LMApp, SeparationApp,
)
from ditsep_tpu_torch.interface.web import (  # noqa: F401
    DemoServer, decode_wav, encode_wav,
)

__all__ = ["AutoencoderApp", "DemoServer", "GenerationApp", "LMApp",
           "SeparationApp",
           "decode_wav", "encode_wav"]
