"""Device selection for the port's entry points.

Entry points default to the CUDA card. They run on the CPU only when the
caller asks for it, and raise when CUDA is asked for but missing: nothing
falls back to the CPU quietly.
"""
from __future__ import annotations

import subprocess
from typing import Tuple, Union

import torch

# dense bf16 tensor-core FLOP/s and memory bytes/s (NVIDIA data sheets), by
# a part of the card's name; other cards are taken as the H100 SXM
CARD_PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H200", 989e12, 4.8e12))
H100_SXM_PEAKS = (989e12, 3.35e12)


def card_peaks(name: str) -> Tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card named ``name``."""
    for key, flops, bandwidth in CARD_PEAKS:
        if key in name:
            return flops, bandwidth
    return H100_SXM_PEAKS


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


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
