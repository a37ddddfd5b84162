"""Carry a flax parameter tree into the port's modules.

The port's parameters are named after the JAX leaves and keep their
layouts, so a flax path ``params/film_0/proj/kernel`` is the torch name
``film_0.proj.kernel`` (``params/embedding_extractor/ecapa/block_0/
res2_kernel_1`` is ``embedding_extractor.ecapa.block_0.res2_kernel_1``)
and the values copy over unchanged.  One loader serves every module of
the port: the generator, the encoders, the vocoder facade and the
discriminators, the S2ST model and the unit vocoder.
:func:`load_jax_train_state`, :func:`load_jax_encoder_state`,
:func:`load_jax_unit_vocoder_state` and :func:`load_jax_s2st_state` carry a
whole JAX train state, optimisers included.

Also the S2ST stack's configs as the JAX package's trainers write them
(``streamspeech_config.json`` with its feature revision,
``code_config.json``), and the port's own checkpoints, each one
``torch.save`` of configs and state dicts, read strictly: the S2ST pair
with its training step (what ``cli simulate`` and ``cli eval-s2st``
``--checkpoint`` read), the run directories of ``cli train-s2st`` and
``cli train-unit-vocoder`` (what they read with ``--checkpoint_dir`` and
``--unit_vocoder``), the judge encoders and the CTC judge (what ``cli
eval --encoders`` / ``--asr`` and ``cli eval-clone --encoders`` read),
and the waveform speaker encoder (what ``SpeakerEncoder`` reads).  Every
flax name of ``WaveformEcapaTdnn``, ``StandaloneGRCBlock``,
``ParallelMRFBlock`` and ``ODConv1d`` is the port's, so
:func:`load_jax_params` fills them too.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.embeddings import EcapaTdnn, Emotion2Vec
from hifigan_tpu_torch.models.streamspeech import FEATURE_REV, StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.models.waveform_encoders import WaveformEcapaTdnn
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, build_models, strip_classifier

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


def _load_jax_state(state, parts, jax_step) -> None:
    """Fill ``(module, optimiser, flax params, optax state)`` ``parts`` and
    ``state.step``; every part is matched before any value changes."""
    params = [(module, _matched(module, tree)) for module, _, tree, _ in parts]
    opts = [(opt, *_adam_state(module, opt, opt_state)) for module, opt, _, opt_state in parts]
    for module, values in params:
        _copy(module, values)
    for opt, opt_state, count in opts:
        opt.adam.load_state_dict(opt_state)
        opt.count = count
    state.step = int(np.asarray(jax_step))


def load_jax_train_state(state, jax_state):
    """Fill a port ``GanTrainState`` from a JAX ``GanTrainState`` whose leaves
    are numpy arrays: both models' parameters (as :func:`load_jax_params`),
    both optimisers' Adam moments and their update count (which sets the
    schedule's count), and ``step``.  The optax state is read as it is
    (``chain(adam(schedule))`` is ``((ScaleByAdamState,
    ScaleByScheduleState),)``); anything that does not match raises before
    any value is changed."""
    _load_jax_state(state, [(state.vocoder, state.gen_opt, jax_state.gen_params, jax_state.gen_opt_state),
                            (state.discriminators, state.disc_opt, jax_state.disc_params,
                             jax_state.disc_opt_state)], jax_state.step)
    return state


def load_jax_encoder_state(state, jax_state):
    """Fill a port ``EncoderTrainState`` from a JAX ``EncoderTrainState``
    whose leaves are numpy arrays: both encoders' parameters with their
    classifier heads, both optax Adam states (``mu`` → ``exp_avg``, ``nu``
    → ``exp_avg_sq``) and update counts (the count sets the emotion
    schedule's position), and ``step``, matched as strictly as
    :func:`load_jax_train_state` matches."""
    _load_jax_state(state, [(state.ecapa, state.ecapa_opt, jax_state.ecapa_params, jax_state.ecapa_opt),
                            (state.emo, state.emo_opt, jax_state.emo_params, jax_state.emo_opt)], jax_state.step)
    return state


# The unit vocoder's train state is a GanTrainState (a CodeVocoder, the
# discriminators, two Adam states): JAX's unit-vocoder state loads as any.
load_jax_unit_vocoder_state = load_jax_train_state


def load_jax_s2st_state(state, jax_state):
    """Fill the port's ``S2STTrainState`` (``create_s2st_state``) from a JAX
    one whose leaves are numpy arrays: the model's parameters, the AdamW
    moments and the update count found inside optax's ``chain(clip,
    chain(scale_by_adam, add_decayed_weights, scale_by_schedule))`` state
    (the clip and the decay hold no state; both counts must agree), and
    ``step``; anything that does not match raises before any value is
    changed."""
    _load_jax_state(state, [(state.model, state.opt, jax_state.params, jax_state.opt_state)], jax_state.step)
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


def _newest_step_file(directory: str) -> tuple[str, int]:
    """The newest ``<step>.pt`` of a run directory and its step."""
    step = CheckpointManager(directory).latest_step()
    if step is None:
        raise FileNotFoundError(f"{directory} holds no <step>.pt checkpoint")
    return os.path.join(directory, f"{step}.pt"), step


def load_s2st_run(directory: str, device: str | torch.device) -> tuple[StreamSpeechS2ST, int]:
    """``(model, step)`` of a ``cli train-s2st`` run directory: its
    ``streamspeech_config.json`` (feature revision checked) and the model of
    its newest ``<step>.pt`` train state (the trainer's tree: the transition
    head, no vocoder), fp32, in eval mode, on ``device``."""
    cfg = load_streamspeech_config(os.path.join(directory, "streamspeech_config.json"))
    path, step = _newest_step_file(directory)
    model = StreamSpeechS2ST(cfg, gen=torch.Generator().manual_seed(0), with_vocoder=False)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    return model.to(device).eval(), step


def load_unit_vocoder_run(directory: str, device: str | torch.device) -> tuple[CodeVocoder, int]:
    """``(code_vocoder, step)`` of a ``cli train-unit-vocoder`` run
    directory: its ``code_config.json`` and the generator of its newest
    ``<step>.pt`` train state, fp32, in eval mode, on ``device``."""
    code_cfg = load_code_config(os.path.join(directory, "code_config.json"))
    path, step = _newest_step_file(directory)
    code_vocoder = CodeVocoder(code_cfg, gen=torch.Generator().manual_seed(0))
    code_vocoder.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["vocoder"])
    return code_vocoder.to(device).eval(), step


def save_s2st_checkpoint(path: str, model: StreamSpeechS2ST, code_vocoder: CodeVocoder, step: int = 0) -> None:
    """Write both models' configs and parameters, and the S2ST model's
    training step, to one ``torch.save`` file."""
    torch.save({
        "streamspeech_config": {**dataclasses.asdict(model.config), "_feature_rev": FEATURE_REV},
        "code_config": dataclasses.asdict(code_vocoder.config),
        "step": int(step),
        "s2st": model.state_dict(),
        "code_vocoder": code_vocoder.state_dict(),
    }, path)


def read_s2st_step(path: str) -> int:
    """The training step a :func:`save_s2st_checkpoint` file records (0 for
    a file written without one)."""
    return int(torch.load(path, map_location="cpu", weights_only=True).get("step", 0))


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


def save_encoder_checkpoint(path: str, cfg: EncoderTrainConfig, ecapa: EcapaTdnn, emotion2vec: Emotion2Vec,
                            step: int = 0) -> None:
    """Write the judge encoders (their config, both state dicts with any
    classifier head stripped, and the training step) to one file."""
    torch.save({"config": dataclasses.asdict(cfg), "step": int(step),
                "ecapa": strip_classifier(ecapa.state_dict()),
                "emotion2vec": strip_classifier(emotion2vec.state_dict())}, path)


def load_encoder_checkpoint(path: str, device: str | torch.device
                            ) -> tuple[EncoderTrainConfig, EcapaTdnn, Emotion2Vec, int]:
    """``(config, ECAPA-TDNN, Emotion2Vec, step)`` of a
    :func:`save_encoder_checkpoint` file, fp32, in eval mode, on
    ``device``; raises unless each state dict fits its model exactly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    d = dict(ckpt["config"])
    cfg = EncoderTrainConfig(**{**d, "mel": MelConfig(**d["mel"])})
    ecapa, emo = build_models(cfg, gen=torch.Generator().manual_seed(0))
    ecapa.load_state_dict(ckpt["ecapa"])
    emo.load_state_dict(ckpt["emotion2vec"])
    return cfg, ecapa.to(device).eval(), emo.to(device).eval(), int(ckpt["step"])


def save_ctc_judge(path: str, model: StreamSpeechS2ST, step: int = 0) -> None:
    """Write a CTC judge (the S2ST trainer's tree: with the transition
    head, without the vocoder), its config with the feature revision and
    its training step to one file."""
    if model.vocoder is not None or model.transition_head is None:
        raise ValueError("a CTC judge is the S2ST trainer's tree: a transition head and no vocoder")
    torch.save({"streamspeech_config": {**dataclasses.asdict(model.config), "_feature_rev": FEATURE_REV},
                "step": int(step), "s2st": model.state_dict()}, path)


def load_ctc_judge(path: str, device: str | torch.device) -> tuple[StreamSpeechS2ST, int]:
    """``(model, step)`` of a :func:`save_ctc_judge` file, fp32, in eval
    mode, on ``device``; the config's feature revision is checked
    (:func:`_streamspeech_config`) and the state dict must fit exactly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = _streamspeech_config(ckpt["streamspeech_config"], path)
    model = StreamSpeechS2ST(cfg, gen=torch.Generator().manual_seed(0), with_vocoder=False)
    model.load_state_dict(ckpt["s2st"])
    return model.to(device).eval(), int(ckpt["step"])


def save_jax_speaker_encoder(path: str, tree: Mapping) -> WaveformEcapaTdnn:
    """Write the JAX package's ``WaveformEcapaTdnn`` params (a flax tree of
    numpy arrays) as the port's speaker-encoder file, the one
    ``SpeakerEncoder(checkpoint_path=)`` reads: the widths, read from the
    tree's shapes, and the state dict.  Returns the filled module."""
    flat = dict(_flatten(tree["params"] if "params" in tree else tree))
    _, n_mels, hidden = np.shape(flat["tdnn_0_kernel"])
    widths = {"n_mels": int(n_mels), "hidden": int(hidden), "embedding_dim": int(np.shape(flat["proj.kernel"])[1])}
    model = load_jax_params(WaveformEcapaTdnn(**widths, gen=torch.Generator().manual_seed(0)), tree)
    torch.save({"widths": widths, "state_dict": model.state_dict()}, path)
    return model


def load_speaker_encoder_checkpoint(path: str, device: str | torch.device) -> WaveformEcapaTdnn:
    """The fp32 ``WaveformEcapaTdnn`` of a :func:`save_jax_speaker_encoder`
    file, in eval mode, on ``device``; the state dict must fit exactly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = WaveformEcapaTdnn(**ckpt["widths"], gen=torch.Generator().manual_seed(0))
    model.load_state_dict(ckpt["state_dict"])
    return model.to(device).eval()
