"""String-target instantiation, hydra-free (port of
ditsep_tpu/utils/import_module.py; reference: src/utils/import_module.py:
4-70)."""
from __future__ import annotations

import importlib
from typing import Any, Dict


def import_name(target: str) -> Any:
    """Import 'pkg.module.Attr' -> the attribute."""
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ImportError(f"cannot import bare name {target!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def module_from_config(config: Dict[str, Any], **extra) -> Any:
    """Instantiate {'_target_': 'pkg.Cls', ...kwargs} like
    hydra.utils.instantiate."""
    cfg = dict(config)
    target = cfg.pop("_target_")
    cls = import_name(target)
    return cls(**{**cfg, **extra})


def run_configured_func(config: Dict[str, Any], *args, **extra) -> Any:
    cfg = dict(config)
    target = cfg.pop("_target_")
    fn = import_name(target)
    return fn(*args, **{**cfg, **extra})
