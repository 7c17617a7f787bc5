"""Device selection for the port's entry points.

Entry points default to the CUDA card. They run on the CPU only when the
caller asks for it, and raise when CUDA is asked for but missing: nothing
falls back to the CPU quietly.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises RuntimeError if a CUDA device is requested and CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --cpu) to run on the CPU")
    return dev
