"""Model introspection.

Counterpart of ``hifigan_tpu/utils/model_info.py``: parameter count,
memory footprint, the per-top-level-module breakdown and the config.  The
port's parameter names are the JAX leaves' paths (``weights.py``), so a
parameter's top-level module is the first component of its name, JAX's
top-level key.
"""

from __future__ import annotations

from typing import Any, Optional

from torch import nn


def model_info(module: nn.Module, config: Optional[Any] = None) -> dict:
    """``{"total_parameters", "parameter_bytes", "parameter_mb",
    "per_module_parameters"}`` of ``module``'s parameters (the breakdown
    keyed by top-level module, sorted), with ``"config"`` as a string when
    ``config`` is given."""
    breakdown: dict[str, int] = {}
    n_params = n_bytes = 0
    for name, p in module.named_parameters():
        n_params += p.numel()
        n_bytes += p.numel() * p.element_size()
        top = name.split(".")[0]
        breakdown[top] = breakdown.get(top, 0) + p.numel()
    info = {
        "total_parameters": n_params,
        "parameter_bytes": n_bytes,
        "parameter_mb": round(n_bytes / 1e6, 2),
        "per_module_parameters": dict(sorted(breakdown.items())),
    }
    if config is not None:
        info["config"] = str(config)
    return info
