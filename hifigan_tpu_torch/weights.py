"""Carry a flax parameter tree into the port's modules.

The port's parameters are named after the JAX leaves and keep their
layouts, so a flax path ``params/film_0/proj/kernel`` is the torch name
``film_0.proj.kernel`` (``params/embedding_extractor/ecapa/block_0/
res2_kernel_1`` is ``embedding_extractor.ecapa.block_0.res2_kernel_1``)
and the values copy over unchanged.  One loader serves every module of
the port: the generator, the encoders, the vocoder facade and the
discriminators, the S2ST model and the unit vocoder.
:func:`load_jax_train_state` carries a whole JAX train state, optimisers
included.

Also the S2ST stack's configs as the JAX package's trainers write them
(``streamspeech_config.json`` with its feature revision,
``code_config.json``), and the port's own S2ST checkpoint: one
``torch.save`` of both models' configs and state dicts, what ``cli
simulate --checkpoint`` reads.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.streamspeech import FEATURE_REV, StreamSpeechConfig, StreamSpeechS2ST

log = logging.getLogger("hifigan_tpu_torch")


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, name)
        else:
            yield name, value


def _matched(module: nn.Module, tree: Mapping) -> dict[str, torch.Tensor]:
    """``tree``'s leaves as fp32 tensors by ``module``'s parameter names;
    raises unless every parameter is matched by one leaf of its shape and
    every leaf by one parameter."""
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
    return values


def _copy(module: nn.Module, values: dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(values[name])


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from a flax param dict (nested dicts of
    numpy arrays, with or without the top-level ``"params"`` key).

    Every parameter must be matched by one leaf of the same shape, and every
    leaf by one parameter; otherwise this raises and changes nothing."""
    _copy(module, _matched(module, tree))
    return module


load_jax_generator_params = load_jax_params  # the generator-slice name, kept for its callers


def _optax_parts(node):
    """The namedtuple states inside an optax chain's nested tuples."""
    if hasattr(node, "_fields"):
        yield node
    elif isinstance(node, (tuple, list)):
        for child in node:
            yield from _optax_parts(child)


def _adam_state(module: nn.Module, opt, opt_state) -> tuple[dict, int]:
    """``opt``'s ``torch.optim`` state dict carrying optax's Adam moments
    (``mu`` → ``exp_avg``, ``nu`` → ``exp_avg_sq``) and update count."""
    parts = list(_optax_parts(opt_state))
    adam = [p for p in parts if {"mu", "nu", "count"} <= set(p._fields)]
    counts = {int(np.asarray(p.count)) for p in parts if "count" in p._fields}
    if len(adam) != 1 or len(counts) != 1:
        raise ValueError(f"expected one Adam state and one update count in the optax state, got "
                         f"{[type(p).__name__ for p in parts]} with counts {sorted(counts)}")
    count = counts.pop()
    mu, nu = _matched(module, adam[0].mu), _matched(module, adam[0].nu)
    name_of = {id(p): name for name, p in module.named_parameters()}
    state = opt.adam.state_dict()
    state["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name_of[id(p)]],
                          "exp_avg_sq": nu[name_of[id(p)]]} for i, p in enumerate(opt.params)}
    return state, count


def load_jax_train_state(state, jax_state):
    """Fill a port ``GanTrainState`` from a JAX ``GanTrainState`` whose leaves
    are numpy arrays: both models' parameters (as :func:`load_jax_params`),
    both optimisers' Adam moments and their update count (which sets the
    schedule's count), and ``step``.  The optax state is read as it is
    (``chain(adam(schedule))`` is ``((ScaleByAdamState,
    ScaleByScheduleState),)``); anything that does not match raises before
    any value is changed."""
    params = [(state.vocoder, _matched(state.vocoder, jax_state.gen_params)),
              (state.discriminators, _matched(state.discriminators, jax_state.disc_params))]
    opts = [(state.gen_opt, *_adam_state(state.vocoder, state.gen_opt, jax_state.gen_opt_state)),
            (state.disc_opt, *_adam_state(state.discriminators, state.disc_opt, jax_state.disc_opt_state))]
    for module, values in params:
        _copy(module, values)
    for opt, opt_state, count in opts:
        opt.adam.load_state_dict(opt_state)
        opt.count = count
    state.step = int(np.asarray(jax_state.step))
    return state


def _streamspeech_config(d: Mapping, where: str = "config") -> StreamSpeechConfig:
    """A ``StreamSpeechConfig`` from its fields; a ``_feature_rev`` other
    than :data:`FEATURE_REV` raises, since weights trained under other
    forward semantics would load and compute something else."""
    d = dict(d)
    rev = d.pop("_feature_rev", None)
    if rev is not None and rev != FEATURE_REV:
        raise ValueError(f"{where}: checkpoint feature rev {rev} != code rev {FEATURE_REV}: it was trained "
                         "under other forward semantics")
    if rev is None:
        log.warning("%s has no _feature_rev; assuming the current forward semantics", where)
    d["vocoder_upsample"] = tuple(d["vocoder_upsample"])
    return StreamSpeechConfig(**d)


def load_streamspeech_config(path: str) -> StreamSpeechConfig:
    """Read a ``streamspeech_config.json`` (the JAX S2ST trainer's), with the
    feature-revision guard of :func:`_streamspeech_config`."""
    with open(path) as f:
        return _streamspeech_config(json.load(f), path)


def load_code_config(path: str) -> CodeVocoderConfig:
    """Read a ``code_config.json`` (the JAX unit-vocoder trainer's)."""
    with open(path) as f:
        d = json.load(f)
    d["upsample_factors"] = tuple(d["upsample_factors"])
    return CodeVocoderConfig(**d)


def save_s2st_checkpoint(path: str, model: StreamSpeechS2ST, code_vocoder: CodeVocoder) -> None:
    """Write both models' configs and parameters to one ``torch.save`` file."""
    torch.save({
        "streamspeech_config": {**dataclasses.asdict(model.config), "_feature_rev": FEATURE_REV},
        "code_config": dataclasses.asdict(code_vocoder.config),
        "s2st": model.state_dict(),
        "code_vocoder": code_vocoder.state_dict(),
    }, path)


def load_s2st_checkpoint(path: str, device: str | torch.device) -> tuple[StreamSpeechS2ST, CodeVocoder]:
    """The two models of a :func:`save_s2st_checkpoint` file, fp32, in eval
    mode, on ``device``.  The S2ST model has the vocoder and the transition
    head when the file has their parameters."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = _streamspeech_config(ckpt["streamspeech_config"], path)
    code_cfg = ckpt["code_config"]
    code_cfg = CodeVocoderConfig(**{**code_cfg, "upsample_factors": tuple(code_cfg["upsample_factors"])})
    keys = ckpt["s2st"].keys()
    gen = torch.Generator().manual_seed(0)
    model = StreamSpeechS2ST(cfg, gen=gen, with_vocoder=any(k.startswith("vocoder.") for k in keys),
                             with_transition_head=any(k.startswith("transition_head.") for k in keys))
    model.load_state_dict(ckpt["s2st"])
    code_vocoder = CodeVocoder(code_cfg, gen=gen)
    code_vocoder.load_state_dict(ckpt["code_vocoder"])
    return model.to(device).eval(), code_vocoder.to(device).eval()
