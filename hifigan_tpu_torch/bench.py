"""``cli bench``: the flagship generator's inference speed on the card, and
four more configs' beside it.

    python -m hifigan_tpu_torch.cli bench [--device cuda]

Counterpart of the repository's root ``bench.py`` (what the JAX package's
``cli bench`` runs): its five configs at its shapes, with its keys.  Prints
one JSON line on stdout,

    {"metric": "audio_sec_per_sec_per_chip_22k05_flagship_inference",
     "value": <the flagship's audio-seconds generated a second, 1 decimal>,
     "unit": "x_realtime", "vs_baseline": <value / 50, 2 decimals>}

and one on stderr: ``{"configs": {name: keys}, "device": {...}, "vs_prev_round":
null}``, the device its name and ``nvidia-smi``'s name and power limit (or
the error that kept ``nvidia-smi`` from giving them).

Every time is :func:`hifigan_tpu_torch.utils.benchit.call_time`'s: a window
of calls made one after another as a user makes them (eager PyTorch, no
CUDA graph, no ``torch.compile``, no profiler), between two CUDA events,
over its calls, after warm-up calls, as JAX's window of n calls over n;
JAX's call counts: 16 a forward, 4 a train step.  A call that stalls moves
the figure.

Where it differs from the JAX command, on purpose:

* ``vs_prev_round`` is null: the JAX command compares the value with the
  ``BENCH_r*.json`` records of earlier rounds, which timed the JAX package
  on a TPU; no record of this command exists to compare with.
* A config that raises makes the command exit 1, its error in its stderr
  entry and the stdout line still printed (the JAX command exits 0).  So
  does a card whose power limit ``nvidia-smi`` cannot read: the configs
  still run, the error stands in the stderr line's ``device``.
* Without a card (``--device cuda``, the default) the stdout line carries
  ``value: null`` and the error and the command exits 3, as the JAX
  command does when its backend is unavailable; it never runs on the CPU
  unless asked (``--device cpu``).
"""

from __future__ import annotations

import gc
import json
import logging
import subprocess
import sys

import torch

from hifigan_tpu_torch.entry import build_generator, build_vocoder, resolve_device
from hifigan_tpu_torch.models.generator import GeneratorConfig, HiFiGANV1Generator
from hifigan_tpu_torch.train.corpus import FormantSpeechDataset
from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler
from hifigan_tpu_torch.train.state import TrainConfig, create_train_state
from hifigan_tpu_torch.train.train_step import make_train_step
from hifigan_tpu_torch.utils.benchit import call_time

log = logging.getLogger(__name__)

METRIC = "audio_sec_per_sec_per_chip_22k05_flagship_inference"
SAMPLE_RATE = 22_050
HOP = 256
TRAIN_SAMPLE_RATE = 16_000
# BASELINE.json's real-time target for the flagship, the command's own
# ratio: vs_baseline = value / 50.
NORTH_STAR = 50.0
# The JAX command's counts (bench.py): timed calls and warm-up calls.
INFER_CALLS, TRAIN_CALLS, FUSED_CALLS, PRODUCTION_CALLS = 16, 4, 5, 3
WARMUP, FUSED_WARMUP = 2, 1


def _normal(seed: int, shape: tuple, device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def flagship_call(batch: int, frames: int, device) -> tuple:
    """``(model, (mel, spk, emo))``: the flagship (``GeneratorConfig()``,
    bf16, seed 0) and its seeded inputs, what :func:`bench_flagship` times."""
    device = resolve_device(device)
    model = build_generator(GeneratorConfig(), torch.bfloat16, device, seed=0)
    return model, (_normal(0, (batch, 80, frames), device), _normal(1, (batch, 192), device),
                   _normal(2, (batch, 256), device))


def hifigan_v1_call(batch: int, frames: int, device) -> tuple:
    """``(model, (mel,))``: the plain HiFi-GAN V1 generator in bf16, seed 0."""
    device = resolve_device(device)
    model = HiFiGANV1Generator(dtype=torch.bfloat16, gen=torch.Generator().manual_seed(0)).to(device).eval()
    return model, (_normal(0, (batch, 80, frames), device),)


def conditioned_call(batch: int, frames: int, device) -> tuple:
    """``(vocoder, (mel,))``: ``ModifiedVocoder(GeneratorConfig())`` in bf16,
    seed 0; called on the mel alone it extracts its embeddings from it."""
    device = resolve_device(device)
    return build_vocoder(GeneratorConfig(), torch.bfloat16, device, seed=0), (_normal(0, (batch, 80, frames), device),)


def _inference(model, args, device, batch: int, frames: int) -> dict:
    with torch.no_grad():
        dt = call_time(model, args, INFER_CALLS, warmup=WARMUP, device=device)
    audio_sec = batch * frames * HOP / SAMPLE_RATE
    return {"rtf": audio_sec / dt, "ms_per_call": dt * 1e3, "audio_sec": audio_sec}


def bench_flagship(batch: int = 8, frames: int = 256, device="cuda") -> dict:
    """The ODConv + GRC-LoRA + FiLM generator's batched 22.05 kHz inference
    (BASELINE.json configs 2-4's shape)."""
    model, args = flagship_call(batch, frames, device)
    return _inference(model, args, args[0].device, batch, frames)


def bench_hifigan_v1(batch: int = 8, frames: int = 256, device="cuda") -> dict:
    """The plain HiFi-GAN V1 generator (BASELINE.json config 1)."""
    model, args = hifigan_v1_call(batch, frames, device)
    r = _inference(model, args, args[0].device, batch, frames)
    return {"rtf": r["rtf"], "ms_per_call": r["ms_per_call"]}


def bench_conditioned(batch: int = 8, frames: int = 256, device="cuda") -> dict:
    """The voice-cloning vocoder with its embeddings extracted from the mel
    by ECAPA-TDNN and Emotion2Vec, then the conditioned synthesis
    (BASELINE.json configs 3-4); times the call's ``"waveform"``."""
    vocoder, args = conditioned_call(batch, frames, device)
    r = _inference(lambda mel: vocoder(mel)["waveform"], args, args[0].device, batch, frames)
    return {"rtf": r["rtf"], "ms_per_call": r["ms_per_call"]}


def train_state(device) -> tuple:
    """``(cfg, state)``: ``TrainConfig(warmup_steps=0)`` and its train state
    in bf16, seed 0, what the train-step configs time."""
    cfg = TrainConfig(warmup_steps=0)
    return cfg, create_train_state(cfg, torch.bfloat16, device, seed=0)


def bench_train_step(batch: int = 4, n_samples: int = 8192, device="cuda") -> dict:
    """A whole GAN training step: the generator, the MPD and MSD, the mel
    and feature-matching losses and both optimisers' updates (BASELINE.json
    config 5).  The JAX command times its step again and again from one
    fixed state; the port's step updates its state in place, so each timed
    call starts from the one before it: the same work."""
    cfg, state = train_state(device)
    step = make_train_step(cfg)
    audio = _normal(1, (batch, n_samples), next(state.vocoder.parameters()).device) * 0.1
    dt = call_time(lambda a: step(state, {"audio": a})[1]["generator_loss"], (audio,), TRAIN_CALLS,
                   warmup=WARMUP, device=audio.device)
    return {"steps_per_sec": 1.0 / dt, "ms_per_step": dt * 1e3,
            "audio_sec_per_step": batch * n_samples / TRAIN_SAMPLE_RATE}


def bench_train_step_fused(batch: int = 4, n_samples: int = 8192, k: int = 8, device="cuda") -> dict:
    """Config 5 with ``k`` optimiser steps a call of the step (``multi_steps``).
    Not among :data:`CONFIGS`, as in the JAX command."""
    cfg, state = train_state(device)
    step = make_train_step(cfg, multi_steps=k)
    audio = _normal(1, (k, batch, n_samples), next(state.vocoder.parameters()).device) * 0.1
    dt = call_time(lambda a: step(state, {"audio": a})[1]["generator_loss"], (audio,), FUSED_CALLS,
                   warmup=FUSED_WARMUP, device=audio.device) / k
    return {"steps_per_sec": 1.0 / dt, "ms_per_step": dt * 1e3, "steps_per_call": k,
            "audio_sec_per_sec": batch * n_samples / TRAIN_SAMPLE_RATE / dt}


def bench_train_step_production(batch: int = 16, n_samples: int = 8192, k: int = 32, device="cuda") -> dict:
    """Config 5 as the flagship and cloning runs were trained: batch 16 ×
    8192 samples, 32 optimiser steps a call, each step's crops drawn on the
    device from a 64-utterance formant bank (``make_device_sampler``).
    Reports the steps a second and the audio-seconds trained a second."""
    cfg, state = train_state(device)
    device = next(state.vocoder.parameters()).device
    bank, lengths = build_audio_bank(FormantSpeechDataset(segment_samples=n_samples, size=64))
    sample_fn = make_device_sampler(torch.from_numpy(bank).to(device), torch.from_numpy(lengths), n_samples, batch)
    step = make_train_step(cfg, multi_steps=k, sample_fn=sample_fn)
    gen = torch.Generator(device).manual_seed(2)
    dt = call_time(lambda g: step(state, g)[1]["generator_loss"], (gen,), PRODUCTION_CALLS,
                   warmup=FUSED_WARMUP, device=device) / k
    return {"steps_per_sec": 1.0 / dt, "ms_per_step": dt * 1e3, "steps_per_call": k, "batch": batch,
            "audio_sec_per_sec": batch * n_samples / TRAIN_SAMPLE_RATE / dt}


# (name, function of the device) in the JAX command's order; the first is
# the flagship, whose rtf is the stdout line's value.
CONFIGS = [
    ("flagship_odconv_grc_film", bench_flagship),
    ("hifigan_v1", bench_hifigan_v1),
    ("conditioned_auto_embeddings", bench_conditioned),
    ("gan_train_step", bench_train_step),
    ("gan_train_step_production", bench_train_step_production),
]


def _contract(value, **extra) -> str:
    return json.dumps({"metric": METRIC, "value": value, "unit": "x_realtime",
                       "vs_baseline": None if value is None else round(value / NORTH_STAR, 2), **extra})


def _device_info(device: torch.device) -> dict:
    """The device's name, and for a card ``nvidia-smi``'s name and power
    limit (a line a card), or under ``error`` why ``nvidia-smi`` gave none."""
    if device.type != "cuda":
        return {"name": str(device)}
    info = {"name": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        info["error"] = f"nvidia-smi: {type(e).__name__}: {e}"[:200]
    else:
        info["nvidia_smi"] = smi.stdout.strip().splitlines()
    return info


def main(device="cuda") -> int:
    """Runs :data:`CONFIGS` on ``device`` in turn, each model freed before
    the next is built, and prints the two lines.  Returns the exit code: 0,
    1 if a config raised or the card's power limit could not be read, 3
    without the card asked for."""
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(_contract(None, error=f"CUDA device unavailable: {e}"))
        return 3
    info = _device_info(device)
    results = {}
    for name, fn in CONFIGS:
        try:
            results[name] = fn(device=device)
        except Exception as e:  # noqa: BLE001 -- every config reports; a failure sets the exit code
            log.exception("bench config %s failed", name)
            results[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"configs": results, "device": info, "vs_prev_round": None}), file=sys.stderr)
    flagship = results[CONFIGS[0][0]]
    if "rtf" in flagship:
        print(_contract(round(flagship["rtf"], 1)))
    else:
        print(_contract(None, error=flagship["error"]))
    return 1 if "error" in info or any("error" in r for r in results.values()) else 0
