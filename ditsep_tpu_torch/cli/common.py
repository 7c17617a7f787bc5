"""Shared CLI plumbing: config resolution with hydra-style overrides."""
from __future__ import annotations

import ast
from typing import Dict

from ditsep_tpu_torch.configs import CONFIG_FAMILIES, override


def parse_overrides(pairs) -> Dict[str, object]:
    """Parse 'a.b.c=value' CLI overrides."""
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def load_config(name: str, overrides=None):
    if name not in CONFIG_FAMILIES:
        raise SystemExit(f"unknown config {name!r}; choose from "
                         f"{sorted(CONFIG_FAMILIES)}")
    return override(CONFIG_FAMILIES[name](), parse_overrides(overrides))
