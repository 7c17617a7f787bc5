"""Demo interface: the separation backend (app) and the stdlib web server."""
from ditsep_tpu_torch.interface.app import SeparationApp  # noqa: F401
from ditsep_tpu_torch.interface.web import (  # noqa: F401
    DemoServer, decode_wav, encode_wav,
)

__all__ = ["DemoServer", "SeparationApp", "decode_wav", "encode_wav"]
