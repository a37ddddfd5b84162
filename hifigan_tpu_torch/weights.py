"""Carry a flax parameter tree into the port's modules.

The port's parameters are named after the JAX leaves and keep their
layouts, so a flax path ``params/film_0/proj/kernel`` is the torch name
``film_0.proj.kernel`` (``params/embedding_extractor/ecapa/block_0/
res2_kernel_1`` is ``embedding_extractor.ecapa.block_0.res2_kernel_1``)
and the values copy over unchanged.  One loader serves every module of
the port: the generator, the encoders and the vocoder facade.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, name)
        else:
            yield name, value


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a flax param dict (nested dicts of
    numpy arrays, with or without the top-level ``"params"`` key).

    Every parameter must be matched by one leaf of the same shape, and every
    leaf by one parameter; otherwise this raises and changes nothing."""
    flat = dict(_flatten(tree["params"] if "params" in tree else tree))
    own = dict(module.named_parameters())
    missing, unexpected = own.keys() - flat.keys(), flat.keys() - own.keys()
    if missing or unexpected:
        raise KeyError(f"parameter mismatch: missing {sorted(missing)}, unexpected {sorted(unexpected)}")
    values = {}
    for name, p in own.items():
        v = torch.from_numpy(np.array(flat[name], dtype=np.float32))
        if v.shape != p.shape:
            raise ValueError(f"{name}: JAX shape {tuple(v.shape)} != port shape {tuple(p.shape)}")
        values[name] = v
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(values[name])
    return module


load_jax_generator_params = load_jax_params  # the generator-slice name, kept for its callers
