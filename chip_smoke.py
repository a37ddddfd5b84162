#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own line:
  1. the card's name and power limit, as nvidia-smi gives them;
  2. build: nvcc compiles each hifigan_tpu_torch/csrc/*.cu (seconds taken,
     and ptxas's registers, spills and shared memory per kernel);
  3. kernel check: the two GRC-step kernels (bf16 on the tensor cores, fp32
     on the tensor cores by the 3xTF32 split) against their plain PyTorch
     version at the flagship's MRF shape [8, 65536, 32], for all nine
     (k, d) steps, with neutral and normalised statistics;
  4. generator: the flagship generator (full config, every parameter
     redrawn from a seed as N(0, 0.3^2/fan)) at batch 8 x 256 mel frames,
     in bf16 and in fp32, each once through the kernel and once through the
     plain path; each kernel must launch 9 times in that run, and in bf16
     dropping the MRF taps must move the output by more than the tolerance
     the two paths are held to;
  5. timing, medians of 25 runs after warm-up: the device time of each step
     in each dtype (kernel, plain version, F.conv1d of the same dilated
     conv) and of a plain copy of a step's input, from CUDA events around
     a CUDA graph of 10 calls; the bf16 and fp32 forwards' wall time, kernel
     and plain path, from CUDA events around one eager call;
  6. cloning: the voice-cloning vocoder (``build_vocoder``: the generator
     plus ECAPA-TDNN 512 -> 192 and Emotion2Vec d 512 x 6 layers x 8 heads
     -> 256, TrainConfig()'s widths) in bf16, cloning 8 reference clips of
     128 frames onto the 8 x 256 content frames of phase 4: the kernel path
     against the plain path, 9 launches of the bf16 kernel per call, and the
     waveform moved by more than that tolerance when the reference batch is
     reversed; the fp32 extractor on the card against the same weights on
     the CPU at 2 x 64 frames; the cloning call's and the generator's alone
     (the extracted embeddings passed in) wall time;
  7. training: the GAN trainer (create_train_state(TrainConfig()) in bf16:
     the cloning vocoder of phase 6 and the MPD/MSD discriminators) for 2 + 5
     steps of 16 x 8192 samples drawn on the card from seeded synthetic rows
     (make_device_sampler), as `cli train --bf16 --device_data` runs it:
     finite losses, no GRC-kernel launch in the train steps (they
     differentiate the plain chain), parameters that change, the median
     step time by CUDA events, audio-seconds trained a second and peak
     memory; the eval step on the kernel path (9 launches) against the plain
     path; one fp32 step on the card against the CPU at 1 x 4096 (TF32 off);
     a checkpoint round trip (save after step 2, restore into a fresh
     trainer, step 3 in both gives the same losses, cuDNN deterministic);
  8. S2ST: the streaming speech-to-speech translation path of `cli
     simulate` (build_s2st_inference(): StreamSpeechConfig(), d 512, 12
     Conformer and 6 decoder layers, 32,000 tokens, 1,000 units, and
     CodeVocoderConfig(), HiFi-GAN V1 at 512 hidden, both fp32 at the
     seeded draw of the JAX package's initialisers), TF32 off: the encoder
     program at one 64-frame bucket, prefill logits for 16 tokens and the
     unit vocoder on 16 units against a CPU copy of the same weights within
     1e-4 of each output's peak, decode_step against prefill on the card;
     then an S2STAgent session over 5 s of 16 kHz synthetic speech in 320
     ms segments, which must write before the source ends, commit text,
     emit units and samples, launch no GRC kernel, and whose KV-cached text
     continuation must equal the uncached one at its first write; then, in
     a second session, its wall time and real-time factor, the median wall
     time of each program at the buckets the session hit, and peak memory;
  9. traces: torch.profiler over 10 forwards of the kernel path, 10 cloning
     calls, 3 train steps and one S2ST session: the device's busy share of
     the window, launches per call (and per policy call of the session),
     the call's peak device memory and device time per kernel family
     (attention, the convolutions' backward, FFT and the optimiser each its
     own), and the device time inside the extractor's and attention's
     profiler ranges; then the bf16 forward's wall time again.
Then one JSON line describing the kernels, and last the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch import (
    GeneratorConfig,
    TrainConfig,
    build_generator,
    build_s2st_inference,
    build_vocoder,
    create_train_state,
)
from hifigan_tpu_torch.ops.cuda import build, grc_kernel
from hifigan_tpu_torch.ops.grc_lora import group_stats
from hifigan_tpu_torch.streaming import incremental as inc
from hifigan_tpu_torch.streaming import run_streaming_session
from hifigan_tpu_torch.streaming.agents import S2STAgent
from hifigan_tpu_torch.streaming.harness import TextSegment
from hifigan_tpu_torch.streaming.runtime import UNIT_BUCKETS, S2STInference, _bucket
from hifigan_tpu_torch.train import audio_to_mel, make_eval_step, make_train_step
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.train.data import SyntheticSpeechDataset
from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler

BATCH, FRAMES, SAMPLE_RATE, HOP = 8, 256, 22050, 256
REF_FRAMES = 128  # the cloning phase's reference clips
EXTRACTOR_CHECK_SHAPE = (2, 64)  # batch, frames of the fp32 extractor's card-vs-CPU check
C, GROUPS = 32, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# bf16: the tensor cores' dense rate.  fp32: the card's fastest fp32-accurate
# route is three TF32 tensor-core products per product (the 3xTF32 split),
# so a third of the 495 TFLOP/s TF32 rate; the CUDA cores' FMAs reach 67.
PEAK_OPS_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
RUNS, WARMUP = 25, 3
GRAPH_CALLS = 10
TRACED_FORWARDS = 10
T_AUDIO = FRAMES * HOP
# The training phase: bench.py::bench_train_step_production's shape (16 x
# 8192 samples, 32 mel frames at 16 kHz), drawn on the card from a bank of
# seeded synthetic rows; the fp32 card-vs-CPU check and the checkpoint round
# trip at batch 1 x 4096.
TRAIN_BATCH, TRAIN_SEGMENT, TRAIN_SAMPLE_RATE, TRAIN_BANK_ROWS = 16, 8192, 16000, 64
TRAIN_WARMUP, TRAIN_TIMED, TRACED_TRAIN_STEPS = 2, 5, 3
TRAIN_CHECK_SEGMENT = 4096
# The S2ST phase: cli simulate's seeded full-width stack in fp32 over 5 s of
# 16 kHz synthetic speech in 320 ms segments; the card-vs-CPU program checks
# at one 64-frame source bucket, 16 tokens and 16 units.
S2ST_AUDIO_SAMPLES, S2ST_SAMPLE_RATE, S2ST_SEGMENT_MS = 80000, 16000, 320
S2ST_CHECK_FRAMES, S2ST_CHECK_TOKENS, S2ST_CHECK_UNITS = 64, 16, 16
S2ST_TAIL_RUNS = 5


def _time_ms(fn, runs: int = RUNS) -> float:
    """Median time of one call, from CUDA events around each run: the
    device's time, or the host's where it sets the pace."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn) -> float:
    """Median device time of one call: GRAPH_CALLS calls captured in a CUDA
    graph, replayed between CUDA events, so that the host's cost of issuing
    a call is not timed.  The calls run back to back on the device, as the
    steps of the forward do, so L2 is warm as it is there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    ms = _time_ms(graph.replay) / GRAPH_CALLS
    del graph
    return ms


def _redraw_parameters(model: torch.nn.Module, seed: int) -> None:
    """Redraw every parameter as N(0, 0.3^2/fan), fan = the product of all
    but the last dim (1 for vectors), as the CPU tests do: the zero-init
    biases and LoRA B take part, and the fused MRF taps weigh many bf16
    ulps against the residual."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            fan = math.prod(p.shape[:-1]) if p.dim() > 1 else 1
            p.copy_(torch.randn(p.shape, generator=g, device=p.device) * (0.3 / fan ** 0.5))


def _family(name: str) -> str:
    low = name.lower()
    if "grc_step" in low:
        return "grc_step (CUDA kernel)"
    if "fft" in low:
        return "FFT (cuFFT)"
    if any(w in low for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolutions forward (cuDNN)"
    if any(w in low for w in ("gemm", "gemv", "xmma", "sm90", "cutlass")):
        return "matmuls (cuBLAS)"
    return "elementwise, reductions, copies"


# Profiler ranges the port's modules open (torch.profiler.record_function):
# the device time of the kernels launched inside each is reported as its own.
SPANS = {"attention": "attention (MultiHeadAttention, projections included)",
         "embedding_extractor": "embedding extractor (ECAPA-TDNN + Emotion2Vec)"}
# CPU ranges, by the start of their name, whose kernels form a family of
# their own whatever their names: attention, the convolutions' backward
# (cuDNN's dgrad and wgrad kernels, some named like forward ones) and
# torch.optim's step (its fused Adam kernels).
FAMILY_RANGES = (("attention", SPANS["attention"]),
                 ("aten::convolution_backward", "convolutions backward (cuDNN)"),
                 ("Optimizer.step", "optimiser (torch.optim fused Adam)"))


def _span_kernels(event):
    """(name, us) of every kernel launched inside a CPU event's range."""
    for k in event.kernels:
        yield k.name, k.duration
    for child in event.cpu_children:
        yield from _span_kernels(child)


def _trace(fn, calls: int = TRACED_FORWARDS) -> dict:
    """Trace ``calls`` calls of ``fn`` with torch.profiler: the device's busy
    share of the window (union of kernel intervals over the window's
    CUDA-event time), launches per call, the peak device memory the calls
    take above what was allocated before them, and device ms per call for
    each kernel family and the top kernels.  Kernels launched inside a
    range of FAMILY_RANGES form that family; the device ms inside each
    range of SPANS, and its share of the device time, are reported apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and e.name not in SPANS]
    if not kernels:
        raise AssertionError("the profiler recorded no device events")
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (cur_s, cur_e) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy_us, cur_s = busy_us + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name, by_family = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / calls
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        by_family[_family(e.name)] = by_family.get(_family(e.name), 0.0) + ms
    device_ms = sum(by_family.values())
    spans = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        family = next((label for prefix, label in FAMILY_RANGES if e.name.startswith(prefix)), None)
        if e.name not in SPANS and family is None:
            continue
        for name, us in _span_kernels(e):
            ms = us / 1e3 / calls
            if e.name in SPANS:
                spans[SPANS[e.name]] = spans.get(SPANS[e.name], 0.0) + ms
            if family is not None:
                by_family[_family(name)] -= ms
                by_family[family] = by_family.get(family, 0.0) + ms
    window_ms = start.elapsed_time(end)
    return {
        "traced_calls": calls,
        "window_ms": window_ms,
        "device_busy_share": busy_us / 1e3 / window_ms,
        "launches_per_call": len(kernels) / calls,
        "device_ms_per_call": device_ms,
        "spans_ms_per_call": {n: {"ms": ms, "share_of_device_ms": ms / device_ms} for n, ms in spans.items()},
        "peak_memory_above_start_mib": (torch.cuda.max_memory_allocated() - held) / 2 ** 20,
        "ms_per_call_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "ms_per_call_top_kernels": [{"name": n[:120], "ms": ms} for n, ms in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
    }


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    exp = torch.frexp(x.abs().clamp_min(2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(x), (exp - 8).to(torch.int32))


def _reference_mels(g: torch.Generator, batch: int, n_mels: int, frames: int) -> torch.Tensor:
    """Reference clips ``[batch, n_mels, frames]`` on the card, each with a
    spectral envelope of its own (an offset per mel bin, constant in time)
    under frame noise, so that their embeddings differ: both encoders pool
    over time, and clips of white noise alone pool to nearly one embedding."""
    noise = torch.randn((batch, n_mels, frames), generator=g, device="cuda")
    return noise * 0.5 + 2.0 * torch.randn((batch, n_mels, 1), generator=g, device="cuda")


def _check_cloning(vocoder, mel: torch.Tensor, ref: torch.Tensor, n_steps: int) -> dict:
    """The cloning call through the kernel path, against the plain path.

    - Launches: ``grc_step_bf16`` exactly ``n_steps`` times in the kernel
      path's call, counted from 0 just before it; ``grc_step_f32`` never.
    - Kernel path against plain path: 4 bf16 ulps at the plain waveform's
      peak, the generator phase's tolerance (the two differ only in fp32
      summation order inside the steps; the extractor is the same code).
    - Live conditioning: reversing the reference batch must move the
      waveform by more than that tolerance, and the embeddings by more
      than 1e-3.
    - Outputs: finite waveform in [-1, 1] of 256 samples a frame; unit
      embeddings of 192 and 256 dims."""
    cfg = vocoder.generator.config
    with torch.no_grad():
        for name in grc_kernel.launches:
            grc_kernel.launches[name] = 0
        out = vocoder(mel, reference_mel=ref)
        torch.cuda.synchronize()
        launches = dict(grc_kernel.launches)
        plain = vocoder(mel, reference_mel=ref, step=grc_kernel.grc_step_reference)
        flipped = vocoder(mel, reference_mel=ref.flip(0))
        torch.cuda.synchronize()
    wav, wav_plain = out["waveform"], plain["waveform"]
    expect = (mel.shape[0], 1, mel.shape[-1] * cfg.upsample_ratio)
    if tuple(wav.shape) != expect or not bool(torch.isfinite(wav).all()) or float(wav.abs().max()) > 1.0:
        raise AssertionError(f"cloning wav {tuple(wav.shape)} (expected {expect}) has non-finite values "
                             "or values outside [-1, 1]")
    for name, dim in (("speaker_embedding", cfg.speaker_dim), ("emotion_embedding", cfg.emotion_dim)):
        norms = out[name].norm(dim=-1)
        if tuple(out[name].shape) != (mel.shape[0], dim) or float((norms - 1).abs().max()) > 1e-3:
            raise AssertionError(f"{name} {tuple(out[name].shape)} is not [{mel.shape[0]}, {dim}] of unit norm")
    if launches != {"grc_step_bf16": n_steps, "grc_step_f32": 0}:
        raise AssertionError(f"the cloning call launched the kernels {launches} times, expected "
                             f"{n_steps} grc_step_bf16 and no grc_step_f32")
    err = float((wav - wav_plain).abs().max())
    tol = 4 * 2.0 ** -8 * float(wav_plain.abs().max())
    moved = float((flipped["waveform"] - wav).abs().max())
    moved_emb = min(float((flipped[n] - out[n]).abs().max()) for n in ("speaker_embedding", "emotion_embedding"))
    if err > tol:
        raise AssertionError(f"cloning kernel path differs from plain path by {err:.3g} > {tol:.3g}")
    if moved <= tol or moved_emb <= 1e-3:
        raise AssertionError(f"reversing the reference batch moves the waveform by {moved:.3g} (tolerance "
                             f"{tol:.3g}) and the embeddings by {moved_emb:.3g}: the conditioning is not live")
    return {"out": out, "launches": launches, "err": err, "tol": tol, "moved": moved, "moved_emb": moved_emb}


def _check_extractor_fp32(seed: int) -> float:
    """The fp32 extractor (TrainConfig() widths, every parameter redrawn) on
    the card against a copy of it on the CPU, on the same reference clips
    of EXTRACTOR_CHECK_SHAPE; TF32 is off, so both sum fp32 products in
    another order only: 1e-4 on the unit embeddings."""
    extractor = build_vocoder(GeneratorConfig(), torch.float32, "cuda", seed=seed).embedding_extractor
    _redraw_parameters(extractor, seed)
    on_cpu = copy.deepcopy(extractor).cpu()
    batch, frames = EXTRACTOR_CHECK_SHAPE
    ref = _reference_mels(torch.Generator(device="cuda").manual_seed(seed), batch, 80, frames)
    with torch.no_grad():
        card = extractor(ref)
        cpu = on_cpu(ref.cpu())
    err = max(float((c.cpu() - h).abs().max()) for c, h in zip(card, cpu))
    if err > 1e-4:
        raise AssertionError(f"the fp32 extractor on the card differs from the CPU by {err:.3g} > 1e-4")
    return err


def _reset_launches() -> None:
    for name in grc_kernel.launches:
        grc_kernel.launches[name] = 0


def _state_tensors(state) -> dict:
    """Every parameter of a train state and its two Adam moments, by name."""
    out = {}
    for model, opt in (("vocoder", state.gen_opt), ("discriminators", state.disc_opt)):
        for name, p in getattr(state, model).named_parameters():
            out[f"{model}.{name}"] = p.detach()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{model}.{name}.{key}"] = opt.adam.state[p][key]
    return out


def _grad_errors(card_state, cpu_state) -> float:
    """Worst gradient error of the card's step against the CPU's, as a share
    of its tolerance: 1e-3 of the leaf's max |g| plus 1e-6 of the model's
    (for leaves whose gradient is zero but for rounding)."""
    worst = 0.0
    for model in ("vocoder", "discriminators"):
        cpu = dict(getattr(cpu_state, model).named_parameters())
        top = max(float(p.grad.abs().max()) for p in cpu.values())
        for name, p in getattr(card_state, model).named_parameters():
            want = cpu[name].grad
            tol = 1e-3 * float(want.abs().max()) + 1e-6 * top
            worst = max(worst, float((p.grad.cpu() - want).abs().max()) / tol)
    return worst


def _check_training(cfg: TrainConfig) -> dict:
    """The GAN trainer on the card, through ``create_train_state`` and
    ``make_train_step`` as ``cli train --device_data --bf16`` drives them.

    - bf16 at TrainConfig() widths, 16 x 8192 samples a step drawn on the
      card: TRAIN_WARMUP + TRAIN_TIMED steps, each timed by CUDA events;
      every loss finite; no grc_step launch (the step differentiates the
      plain GRC chain, as JAX trains on its XLA chain); more than 90% of the
      generator's and the discriminators' parameter tensors changed (the
      first update has learning rate 0, the warmup's start); peak memory.
    - The eval step (no_grad, the kernel path): 9 grc_step_bf16 launches,
      its waveform within the generator phase's tolerance (4 bf16 ulps of
      the peak) of the plain path's.
    - fp32, batch 1 x TRAIN_CHECK_SEGMENT, TF32 off: one step on the card
      against the same step on the CPU (same weights, same audio): every
      loss within 1e-4 relative, every parameter's gradient within 1e-3 of
      its leaf's max |g| plus 1e-6 of its model's.  The vocoder's
      parameters are redrawn first (_redraw_parameters): at the seeded draw
      of the JAX package's initialisers the generator's output is nearly
      silent, its log-mel sits on the 1e-5 floor, and bins a rounding away
      from the floor switch the mel loss's gradient on or off on one side
      only.  The discriminators keep that draw: redrawn, their biases
      swamp their input, and the feature-matching loss becomes a difference
      of nearly equal outputs.
    - Checkpoint round trip, cuDNN deterministic: after step 2 of the fp32
      card trainer, save; take step 3; a fresh trainer restored from the
      file holds the same parameters and Adam moments bit for bit, and its
      step 3 on the same audio gives the same losses bit for bit."""
    state = create_train_state(cfg, torch.bfloat16, "cuda", seed=0)
    bank, lengths = build_audio_bank(SyntheticSpeechDataset(segment_samples=TRAIN_SEGMENT, size=TRAIN_BANK_ROWS))
    sample = make_device_sampler(torch.from_numpy(bank).cuda(), torch.from_numpy(lengths), TRAIN_SEGMENT,
                                 TRAIN_BATCH)
    step = make_train_step(cfg, sample_fn=sample)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = {m: {n: p.detach().clone() for n, p in getattr(state, m).named_parameters()}
              for m in ("vocoder", "discriminators")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_launches()
    times, metrics = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append(m)
    train_launches = dict(grc_kernel.launches)
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if not all(math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"non-finite training losses: {losses}")
    if any(train_launches.values()):
        raise AssertionError(f"the train steps launched the GRC kernels {train_launches} times, expected none")
    changed = {m: sum(not torch.equal(p.detach(), before[m][n]) for n, p in getattr(state, m).named_parameters())
               for m in before}
    for m, n in changed.items():
        if n <= 0.9 * len(before[m]):
            raise AssertionError(f"only {n} of the {len(before[m])} {m} parameter tensors changed in training")
    del before

    audio = sample(torch.Generator(device="cuda").manual_seed(1))
    _reset_launches()
    evaluated = make_eval_step(cfg)(state.vocoder, {"audio": audio})
    torch.cuda.synchronize()
    eval_launches = dict(grc_kernel.launches)
    with torch.no_grad():
        plain = state.vocoder(audio_to_mel(audio, cfg), step=grc_kernel.grc_step_reference)["waveform"]
    wav = evaluated["waveform"]
    eval_err = float((wav - plain).abs().max())
    eval_tol = 4 * 2.0 ** -8 * float(plain.abs().max())
    if eval_launches != {"grc_step_bf16": 9, "grc_step_f32": 0}:
        raise AssertionError(f"the eval step launched the kernels {eval_launches} times, expected 9 grc_step_bf16")
    if tuple(wav.shape) != (TRAIN_BATCH, 1, TRAIN_SEGMENT) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"eval waveform {tuple(wav.shape)} is not finite [{TRAIN_BATCH}, 1, {TRAIN_SEGMENT}]")
    if eval_err > eval_tol:
        raise AssertionError(f"eval step kernel path differs from plain path by {eval_err:.3g} > {eval_tol:.3g}")

    card, cpu = (create_train_state(cfg, torch.float32, dev, seed=5) for dev in ("cuda", "cpu"))
    _redraw_parameters(card.vocoder, seed=7)
    for model in ("vocoder", "discriminators"):
        getattr(cpu, model).load_state_dict(getattr(card, model).state_dict())
    rows = [torch.from_numpy(bank[i:i + 1, :TRAIN_CHECK_SEGMENT].copy()) for i in (3, 4, 5)]
    plain_step = make_train_step(cfg)
    m_card = {k: float(v) for k, v in plain_step(card, {"audio": rows[0].cuda()})[1].items()}
    m_cpu = {k: float(v) for k, v in plain_step(cpu, {"audio": rows[0]})[1].items()}
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    grad_share = _grad_errors(card, cpu)
    if loss_err > 1e-4 or grad_share > 1:
        raise AssertionError(f"the fp32 step on the card differs from the CPU's: losses {m_card} vs {m_cpu} "
                             f"(max rel err {loss_err:.3g}), gradients at {grad_share:.3g} of their tolerance")
    del cpu

    torch.backends.cudnn.deterministic = True
    try:
        plain_step(card, {"audio": rows[1].cuda()})
        with tempfile.TemporaryDirectory() as directory:
            mgr = CheckpointManager(directory)
            if not mgr.save(card) or mgr.all_steps() != [2]:
                raise AssertionError(f"the checkpoint of step 2 was not written: {mgr.all_steps()}")
            saved = {k: v.clone() for k, v in _state_tensors(card).items()}
            m3 = plain_step(card, {"audio": rows[2].cuda()})[1]
            fresh = mgr.restore(create_train_state(cfg, torch.float32, "cuda", seed=6))
        restored = _state_tensors(fresh)
        differ = [k for k, v in saved.items() if not torch.equal(v, restored[k])]
        if differ or fresh.step != 2 or fresh.gen_opt.count != 2 or fresh.disc_opt.count != 2:
            raise AssertionError(f"the restored state differs from the saved one: {differ[:5]}, step {fresh.step}")
        m3_restored = plain_step(fresh, {"audio": rows[2].cuda()})[1]
        if any(not torch.equal(m3[k], m3_restored[k]) for k in m3):
            raise AssertionError(f"step 3 after a restore gives other losses: {m3} vs {m3_restored}")
    finally:
        torch.backends.cudnn.deterministic = False
    n_params = {m: sum(p.numel() for p in getattr(state, m).parameters()) for m in ("vocoder", "discriminators")}
    return {"state": state, "step": step, "gen": gen, "times": times, "losses": losses, "peak_mib": peak_mib,
            "train_launches": train_launches, "changed": changed, "n_params": n_params, "n_tensors":
            {m: len(list(getattr(state, m).parameters())) for m in n_params}, "eval_launches": eval_launches,
            "eval_err": eval_err, "eval_tol": eval_tol, "loss_err": loss_err, "grad_share": grad_share,
            "round_trip_losses": {k: float(v) for k, v in m3.items()}}


def _peak_err(card: torch.Tensor, cpu: torch.Tensor) -> tuple[float, float]:
    """(max |card − cpu|, 1e-4 of the CPU output's peak)."""
    return float((card.cpu() - cpu).abs().max()), 1e-4 * float(cpu.abs().max())


def _encoder_program(model, mel: torch.Tensor) -> dict:
    """What ``S2STInference.encode_prefix`` computes on the device."""
    enc = model.encoder(mel, chunked=True)
    return {"encoder": enc, "source_ctc": model.source_ctc(enc), "target_ctc": model.target_ctc(enc),
            "t2u": model.t2u_encoder(enc)}


def _check_s2st_programs(inf: S2STInference, twin: S2STInference) -> dict:
    """The S2ST programs on the card against the same weights on the CPU
    (``twin``), TF32 off, within 1e-4 of each output's peak: the encoder
    program at one S2ST_CHECK_FRAMES-frame bucket (encoder output, both CTC
    heads, T2U); ``prefill`` logits for S2ST_CHECK_TOKENS tokens over the
    CPU's encoder output; ``decode_step`` token by token against the card's
    own ``prefill``; the unit vocoder on S2ST_CHECK_UNITS units (durations
    equal, waveform).  Returns each check's (max err, tolerance)."""
    g = torch.Generator().manual_seed(21)
    cfg = inf.model.config
    mel = torch.randn((1, S2ST_CHECK_FRAMES, cfg.input_dim), generator=g)
    tokens = torch.randint(3, cfg.vocab_size, (1, S2ST_CHECK_TOKENS), generator=g)
    tokens[0, 0] = inf.cfg.bos_id
    units = torch.randint(1, inf.code_vocoder.config.unit_vocab_size, (1, S2ST_CHECK_UNITS), generator=g)
    checks = {}
    dev = inf.device
    with torch.no_grad():
        card, cpu = _encoder_program(inf.model, mel.to(dev)), _encoder_program(twin.model, mel)
        for name in card:
            checks[f"encoder program: {name}"] = _peak_err(card[name], cpu[name])
        enc = cpu["encoder"]
        spec = inc.DecoderSpec.of(inf.model.text_decoder)
        prefills = {}
        for side, model, side_dev in (("card", inf.model, dev), ("cpu", twin.model, twin.device)):
            decoder = model.text_decoder
            ckv = inc.cross_kv(decoder, enc.to(side_dev))
            prefills[side] = inc.prefill(decoder, ckv, tokens.to(side_dev),
                                         inc.init_cache(spec, 1, S2ST_CHECK_TOKENS, side_dev))[0]
            if side == "card":
                cache, steps = inc.init_cache(spec, 1, S2ST_CHECK_TOKENS, dev), []
                for i in range(S2ST_CHECK_TOKENS):
                    logits, cache = inc.decode_step(decoder, ckv, cache, tokens[:, i].to(dev))
                    steps.append(logits)
                checks["decode_step vs prefill (card)"] = _peak_err(torch.stack(steps, 1), prefills["card"].cpu())
        checks["prefill logits"] = _peak_err(prefills["card"], prefills["cpu"])
        wav, dur, n = inf.code_vocoder(units.to(dev))
        wav_cpu, dur_cpu, n_cpu = twin.code_vocoder(units)
    if not torch.equal(dur.cpu(), dur_cpu) or int(n) != int(n_cpu):
        raise AssertionError(f"unit vocoder durations differ, card {dur.tolist()} vs CPU {dur_cpu.tolist()}")
    checks["unit vocoder waveform"] = _peak_err(wav, wav_cpu)
    for name, (err, tol) in checks.items():
        if not err <= tol:
            raise AssertionError(f"S2ST {name}: card vs CPU max err {err:.3g} > {tol:.3g}")
    return checks


def _s2st_session(inf: S2STInference, audio) -> dict:
    """One ``S2STAgent`` session as ``cli simulate --agent s2st`` runs it,
    instrumented: policy calls, the source and unit buckets hit, and, at the
    first call of the text continuation that gives tokens, the KV-cached
    continuation against the uncached one (``session=None``) on the card;
    GRC-kernel launches counted from 0 just before the session."""
    agent = S2STAgent(inf)
    seen = {"policy_calls": 0, "source_buckets": set(), "unit_buckets": set(), "cached_vs_uncached": None}
    policy, encode, cont, synth = agent.policy, inf.encode_prefix, inf.continue_text, inf.synthesize_tail

    def counted_policy(states):
        seen["policy_calls"] += 1
        return policy(states)

    def bucketed_encode(mel_frames):
        seen["source_buckets"].add(_bucket(mel_frames.shape[0], inf.chunk, inf.cfg.source_buckets))
        return encode(mel_frames)

    def checked_continue(enc, prefix_ids, max_new_tokens=None, session=None):
        out = cont(enc, prefix_ids, max_new_tokens, session)
        if out and session is not None and seen["cached_vs_uncached"] is None:
            seen["cached_vs_uncached"] = (out, cont(enc, prefix_ids, max_new_tokens))
        return out

    def bucketed_synth(all_units, n_new_units):
        seen["unit_buckets"].add(_bucket(len(all_units), 8, UNIT_BUCKETS))
        return synth(all_units, n_new_units)

    agent.policy = counted_policy
    inf.encode_prefix, inf.continue_text, inf.synthesize_tail = bucketed_encode, checked_continue, bucketed_synth
    try:
        _reset_launches()
        result = run_streaming_session(agent, audio, sample_rate=S2ST_SAMPLE_RATE, segment_size_ms=S2ST_SEGMENT_MS)
        seen["launches"] = dict(grc_kernel.launches)
    finally:
        del inf.encode_prefix, inf.continue_text, inf.synthesize_tail
    mid = [(t, s) for t, s in zip(result.emission_source_seconds, result.outputs) if t < result.source_seconds
           and (s.content.strip() if isinstance(s, TextSegment) else len(s.samples))]
    return {"result": result, "agent": agent, "mid_stream_writes": len(mid), **seen}


def _check_s2st_session(run: dict) -> None:
    """The session must write before the source ends, commit text tokens,
    emit units and samples (finite, in [-1, 1]), launch no GRC kernel, and
    its KV-cached continuation must equal the uncached one."""
    result, agent = run["result"], run["agent"]
    wav = result.waveform
    if not run["mid_stream_writes"]:
        raise AssertionError("the S2ST session wrote nothing before the source ended")
    if not agent.committed_text_ids or not agent.emitted_units or not len(wav):
        raise AssertionError(f"the S2ST session committed {len(agent.committed_text_ids)} tokens, emitted "
                             f"{len(agent.emitted_units)} units and {len(wav)} samples: expected some of each")
    if not bool(np.isfinite(wav).all()) or float(np.abs(wav).max()) > 1.0:
        raise AssertionError("the S2ST waveform has non-finite values or values outside [-1, 1]")
    if any(run["launches"].values()):
        raise AssertionError(f"the S2ST session launched the GRC kernels {run['launches']}: it runs none")
    cached, uncached = run["cached_vs_uncached"]
    if cached != uncached:
        raise AssertionError(f"KV-cached continuation {cached} != uncached {uncached}")


def _time_s2st(inf: S2STInference, audio, run: dict) -> dict:
    """Wall times, before any trace: the whole session (host clock, ending
    in a synchronise) and its real-time factor; the median of each program
    by CUDA events (``_time_ms``): ``encode_prefix`` at each source bucket
    the session hit, one ``decode_step`` at position 8, ``synthesize_tail``
    at the smallest and the largest unit bucket it hit (S2ST_TAIL_RUNS runs
    each: the largest re-vocodes the whole unit prefix); the session's peak
    device memory above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    again = run_streaming_session(S2STAgent(inf), audio, sample_rate=S2ST_SAMPLE_RATE,
                                  segment_size_ms=S2ST_SEGMENT_MS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    first = run["result"]
    if ([getattr(s, "content", None) for s in again.outputs] != [getattr(s, "content", None) for s in first.outputs]
            or not np.array_equal(again.waveform, first.waveform)):
        raise AssertionError("a second S2ST session over the same audio gave other outputs")
    g = torch.Generator().manual_seed(22)
    cfg = inf.model.config
    programs = {}
    with torch.no_grad():
        for bucket in sorted(run["source_buckets"]):
            mel = torch.randn((bucket, cfg.input_dim), generator=g).numpy()
            programs[f"encode_prefix {bucket} frames"] = _time_ms(lambda: inf.encode_prefix(mel))
        enc = inf.encode_prefix(mel)["enc"]
        decoder = inf.model.text_decoder
        ckv = inc.cross_kv(decoder, enc)
        cache = inc.init_cache(inf.decoder_spec, 1, inf.cfg.max_target_len, "cuda")
        token = torch.tensor([5], device="cuda")
        programs["decode_step"] = _time_ms(lambda: inc.decode_step(decoder, ckv, inc.with_index(cache, 8), token))
        hit = sorted(run["unit_buckets"])
        units = torch.randint(1, inf.code_vocoder.config.unit_vocab_size, (hit[-1],), generator=g).tolist()
        for bucket in sorted({hit[0], hit[-1]}):
            programs[f"synthesize_tail {bucket} units"] = _time_ms(lambda: inf.synthesize_tail(units[:bucket], 8),
                                                                   runs=S2ST_TAIL_RUNS)
    source_s = S2ST_AUDIO_SAMPLES / S2ST_SAMPLE_RATE
    return {"session_wall_s": wall_s, "rtf": wall_s / source_s, "programs_ms": programs, "peak_mib": peak_mib}


def _step_inputs(k, d, dtype, normalised, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    pre = (torch.randn((BATCH, T_AUDIO, C), generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = (torch.randn((k, C, C), generator=g, device=dev) / (k * C) ** 0.5).to(dtype)
    bias = torch.randn(C, generator=g, device=dev) * 0.1
    if normalised:
        pf = pre.float()
        mean, inv = group_stats(pf.sum(1), pf.square().sum(1), T_AUDIO * C // GROUPS, GROUPS)
        gamma = torch.rand((BATCH, C), generator=g, device=dev) + 0.5
        beta = torch.randn((BATCH, C), generator=g, device=dev) * 0.1
        slope = 0.1
    else:
        mean = torch.zeros((BATCH, C), device=dev)
        inv = gamma = torch.ones((BATCH, C), device=dev)
        beta, slope = mean, 1.0
    return (pre, mean.contiguous(), inv.contiguous(), gamma, beta, w, bias, slope), (k - 1) * d // 2


def _check_step(got, want, dtype):
    """Kernel against plain version.  Tolerances:
    - fp32 pre_out: 1e-4 abs.  Both sum k*32 products of O(1) values in
      fp32; only the order differs.
    - bf16 pre_out: 2 bf16 ulps of the plain value, plus 1e-5 of the
      largest |pre_out| for values near zero.  Both round the same fp32 sum
      to bf16; a different fp32 summation order can move the rounding by one
      ulp, and near zero the fp32 order error exceeds a bf16 ulp.
    - sums: 1e-4 relative to sum(|x|) (for sum x) and to sum(x^2).  Both are
      fp32 sums of the same fp32 values over 65536 steps, in another order
      (per-tile partials + torch sum vs torch sum)."""
    out_g, out_w = got[0].float(), want[0].float()
    err = (out_g - out_w).abs()
    if dtype == torch.float32:
        bad = int((err > 1e-4).sum())
    else:
        bad = int((err > 2 * _bf16_ulp(out_w) + 1e-5 * out_w.abs().max()).sum())
    scale1 = out_w.abs().sum(1)
    scale2 = want[2]
    rel1 = float(((got[1] - want[1]).abs() / scale1).max())
    rel2 = float(((got[2] - want[2]).abs() / scale2).max())
    if bad or rel1 > 1e-4 or rel2 > 1e-4:
        raise AssertionError(f"kernel disagrees with plain version ({dtype}): {bad} pre_out values "
                             f"out of tolerance (max abs err {float(err.max()):.3g}), "
                             f"sum rel err {rel1:.3g}, sum-sq rel err {rel2:.3g}")
    return float(err.max()), max(rel1, rel2)


def _step_bound_ms(k, dtype):
    """Least time for one step: read pre, write pre_out, read W2 and the
    statistics, write the two sums; against 2*B*T*k*C*C operations at
    PEAK_OPS_PER_S (fp32: three TF32 products each)."""
    es = torch.finfo(dtype).bits // 8
    n = BATCH * T_AUDIO * C
    nbytes = 2 * n * es + k * C * C * es + (4 * BATCH * C + C + 2 * BATCH * C) * 4
    ops = 2 * BATCH * T_AUDIO * k * C * C
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS_PER_S[dtype]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    # 2. build
    build.load_library()
    how = f"{build.build_seconds:.2f} s cold" if build.build_seconds is not None else "cached"
    print(f"build: nvcc {' '.join(build.NVCC_FLAGS)} -> {build.library_path().name}: {how}; ptxas: "
          + "; ".join((build.ptxas or "no report").splitlines()))

    cfg = GeneratorConfig()
    steps = [(k, d) for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations) for d in dils]

    # 3. kernel against plain version
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    for dtype in worst:
        for i, (k, d) in enumerate(steps):
            for normalised in (False, True):
                args, lo = _step_inputs(k, d, dtype, normalised, seed=100 * i + normalised)
                got = grc_kernel.grc_step(*args, lo=lo, dilation=d)
                want = grc_kernel.grc_step_reference(*args, lo=lo, dilation=d)
                torch.cuda.synchronize()
                e, r = _check_step(got, want, dtype)
                worst[dtype] = (max(worst[dtype][0], e), max(worst[dtype][1], r))
    print("kernel_check: 9 steps x {neutral, normalised} at "
          f"[{BATCH}, {T_AUDIO}, {C}] agree; max |pre_out err| fp32 {worst[torch.float32][0]:.3g} "
          f"(tol 1e-4), bf16 {worst[torch.bfloat16][0]:.3g} (tol 2 ulp); max sum rel err "
          f"{max(worst[torch.float32][1], worst[torch.bfloat16][1]):.3g} (tol 1e-4)")

    # 4. generator: the main path, through the entry point a user calls, in
    # bf16 (the flagship) and fp32, so that each kernel runs on it
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        models[dtype] = build_generator(cfg, dtype, "cuda", seed=0)
        _redraw_parameters(models[dtype], seed=3)
    model = models[torch.bfloat16]
    g = torch.Generator(device="cuda").manual_seed(1)
    mel = torch.randn((BATCH, cfg.input_channels, FRAMES), generator=g, device="cuda")
    spk = torch.randn((BATCH, cfg.speaker_dim), generator=g, device="cuda")
    emo = torch.randn((BATCH, cfg.emotion_dim), generator=g, device="cuda")

    def no_taps(pre, mean, inv, gamma, beta, w, bias, slope, *, lo, dilation):
        return grc_kernel.grc_step_reference(pre, mean, inv, gamma, beta, torch.zeros_like(w), bias,
                                             slope, lo=lo, dilation=dilation)

    with torch.no_grad():
        for name in grc_kernel.launches:
            grc_kernel.launches[name] = 0
        wavs = {dtype: m(mel, spk, emo) for dtype, m in models.items()}
        torch.cuda.synchronize()
        launches = dict(grc_kernel.launches)
        wavs_plain = {dtype: m(mel, spk, emo, step=grc_kernel.grc_step_reference) for dtype, m in models.items()}
        wav_no_taps = model(mel, spk, emo, step=no_taps)
        torch.cuda.synchronize()
    expect_shape = (BATCH, 1, FRAMES * cfg.upsample_ratio)
    for dtype, wav in wavs.items():
        if tuple(wav.shape) != expect_shape:
            raise AssertionError(f"{dtype} wav shape {tuple(wav.shape)} != {expect_shape}")
        if not bool(torch.isfinite(wav).all()) or float(wav.abs().max()) > 1.0:
            raise AssertionError(f"{dtype} wav has non-finite values or values outside [-1, 1]")
    if launches != {"grc_step_f32": len(steps), "grc_step_bf16": len(steps)}:
        raise AssertionError(f"the forwards launched the kernels {launches} times, expected {len(steps)} each")
    # The two paths differ only in fp32 summation order inside the 9 steps.
    # bf16: that can move a bf16 rounding by one ulp; allow 4 bf16 ulps at
    # the output's peak.  The check must be able to see the MRF taps: a path
    # that drops them has to land outside that tolerance.  fp32: the step's
    # own tolerance, 1e-4.
    wav, wav_plain = wavs[torch.bfloat16], wavs_plain[torch.bfloat16]
    gen_err = float((wav - wav_plain).abs().max())
    gen_tol = 4 * 2.0 ** -8 * float(wav_plain.abs().max())
    taps_effect = float((wav_no_taps - wav_plain).abs().max())
    gen_err_f32 = float((wavs[torch.float32] - wavs_plain[torch.float32]).abs().max())
    if gen_err > gen_tol:
        raise AssertionError(f"generator kernel path differs from plain path by {gen_err:.3g} > {gen_tol:.3g}")
    if taps_effect <= gen_tol:
        raise AssertionError(f"dropping the MRF taps moves the output by {taps_effect:.3g}, within the "
                             f"tolerance {gen_tol:.3g}: the generator check cannot see the kernel")
    if gen_err_f32 > 1e-4:
        raise AssertionError(f"fp32 generator kernel path differs from plain path by {gen_err_f32:.3g} > 1e-4")
    saturated = float((wav.abs() > 0.99).float().mean())
    print(f"generator: wav {tuple(wav.shape)} bf16 finite, max|wav| {float(wav.abs().max()):.4f}, "
          f"std {float(wav.std()):.4f}, share |wav| > 0.99 {saturated:.4f}; kernel vs plain path max err "
          f"{gen_err:.3g} (tol {gen_tol:.3g}); without the MRF taps max diff {taps_effect:.3g} "
          f"({taps_effect / gen_tol:.1f}x tol); fp32 kernel vs plain path max err {gen_err_f32:.3g} "
          f"(tol 1e-4); kernel launches {launches}")

    # 5. timing (normalised statistics: the main path's case)
    rows = {torch.bfloat16: [], torch.float32: []}
    lib = build.load_library()
    with torch.no_grad():
        for dtype, dtype_rows in rows.items():
            for i, (k, d) in enumerate(steps):
                args, lo = _step_inputs(k, d, dtype, True, seed=100 * i + 1)
                y_cf = args[0].transpose(1, 2).contiguous()
                w_lib = args[5].permute(2, 1, 0).contiguous()
                ms = _device_ms(lambda: grc_kernel.grc_step(*args, lo=lo, dilation=d))
                plain_ms = _device_ms(lambda: grc_kernel.grc_step_reference(*args, lo=lo, dilation=d))
                lib_ms = _device_ms(lambda: F.conv1d(y_cf, w_lib, padding=lo, dilation=d))
                bytes_ms, ops_ms = _step_bound_ms(k, dtype)
                row = {"k": k, "d": d, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bytes_ms": bytes_ms, "ops_ms": ops_ms}
                ctas = lib.grc_step_bf16_ctas_per_sm if dtype == torch.bfloat16 else lib.grc_step_f32_ctas_per_sm
                row["ctas_per_sm"] = ctas(k, d)
                dtype_rows.append(row)
        src = torch.empty((BATCH, T_AUDIO, C), dtype=torch.bfloat16, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = _device_ms(lambda: dst.copy_(src))
        fwd_ms, fwd_plain_ms = {}, {}
        for dtype, m in models.items():
            fwd_ms[dtype] = _time_ms(lambda: m(mel, spk, emo))
            fwd_plain_ms[dtype] = _time_ms(lambda: m(mel, spk, emo, step=grc_kernel.grc_step_reference))
    audio_s = BATCH * FRAMES * HOP / SAMPLE_RATE
    print("timing_steps_bf16: " + json.dumps(rows[torch.bfloat16]))
    print("timing_steps_fp32: " + json.dumps(rows[torch.float32]))
    print(f"timing_copy: a copy of one bf16 step's input [{BATCH}, {T_AUDIO}, {C}] (its bytes read once and "
          f"written once) {copy_ms:.4f} ms")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        print(f"timing_forward: batch {BATCH} x {FRAMES} frames {name}: kernel path {fwd_ms[dtype]:.3f} ms "
              f"({audio_s / fwd_ms[dtype] * 1e3:.1f} audio-s/s), plain path {fwd_plain_ms[dtype]:.3f} ms "
              f"({audio_s / fwd_plain_ms[dtype] * 1e3:.1f} audio-s/s)")

    # 6. cloning: the voice-cloning vocoder through build_vocoder, in bf16.
    # The generator is redrawn as in phase 4; the extractor keeps the seeded
    # draw of the JAX package's initialisers (lecun-normal Dense kernels,
    # zero biases, unit LayerNorm scales): redrawn as the generator is, its
    # biases swamp its input and every reference gives nearly one embedding,
    # so no check could see the conditioning.  The fp32 extractor check
    # redraws every parameter.
    vocoder = build_vocoder(cfg, torch.bfloat16, "cuda", seed=0)
    _redraw_parameters(vocoder.generator, seed=3)
    ref = _reference_mels(torch.Generator(device="cuda").manual_seed(2), BATCH, cfg.input_channels, REF_FRAMES)
    clone = _check_cloning(vocoder, mel, ref, len(steps))
    ext_err = _check_extractor_fp32(seed=4)
    print(f"cloning: wav {tuple(clone['out']['waveform'].shape)} from content [{BATCH}, {cfg.input_channels}, "
          f"{FRAMES}] and references [{BATCH}, {cfg.input_channels}, {REF_FRAMES}], bf16 finite; kernel vs plain "
          f"path max err {clone['err']:.3g} (tol {clone['tol']:.3g}); reversing the references moves the wav by "
          f"{clone['moved']:.3g} ({clone['moved'] / clone['tol']:.1f}x tol) and the embeddings by "
          f"{clone['moved_emb']:.3g}; fp32 extractor card vs CPU at {list(EXTRACTOR_CHECK_SHAPE)} max err "
          f"{ext_err:.3g} (tol 1e-4); kernel launches {clone['launches']}")
    spk_x, emo_x = clone["out"]["speaker_embedding"], clone["out"]["emotion_embedding"]
    with torch.no_grad():
        clone_ms = _time_ms(lambda: vocoder(mel, reference_mel=ref))
        gen_alone_ms = _time_ms(lambda: vocoder(mel, spk_x, emo_x))
    print(f"timing_cloning: batch {BATCH} x {FRAMES} content frames, {BATCH} x {REF_FRAMES} reference frames, "
          f"bf16: cloning call {clone_ms:.3f} ms ({audio_s / clone_ms * 1e3:.1f} audio-s/s); generator alone with "
          f"the extracted embeddings passed in {gen_alone_ms:.3f} ms ({audio_s / gen_alone_ms * 1e3:.1f} audio-s/s)")

    # 7. training: the GAN trainer at TrainConfig() widths, checked and
    # timed before any trace
    train = _check_training(TrainConfig())
    print(f"train: TrainConfig() bf16, {train['n_params']['vocoder']} generator + extractor and "
          f"{train['n_params']['discriminators']} discriminator parameters, {TRAIN_BATCH} x {TRAIN_SEGMENT} samples a "
          f"step from the on-card sampler; {TRAIN_WARMUP + TRAIN_TIMED} steps, losses finite: "
          f"{json.dumps(train['losses'])}; kernel launches in the train steps {train['train_launches']}; parameter "
          f"tensors changed {train['changed']} of {train['n_tensors']}; eval step kernel vs plain path max err "
          f"{train['eval_err']:.3g} (tol {train['eval_tol']:.3g}), kernel launches {train['eval_launches']}; fp32 "
          f"card vs CPU at [1, {TRAIN_CHECK_SEGMENT}]: max loss rel err {train['loss_err']:.3g} (tol 1e-4), worst "
          f"gradient err {train['grad_share']:.3g} of its tolerance; checkpoint round trip after step 2: state "
          f"restored bit for bit, step 3 losses equal {json.dumps(train['round_trip_losses'])}")
    step_ms = statistics.median(train["times"][TRAIN_WARMUP:])
    train_audio_s = TRAIN_BATCH * TRAIN_SEGMENT / TRAIN_SAMPLE_RATE
    print(f"timing_train: {TRAIN_BATCH} x {TRAIN_SEGMENT} samples, bf16: median {step_ms:.3f} ms a step over "
          f"{TRAIN_TIMED} steps after {TRAIN_WARMUP} ({json.dumps([round(t, 3) for t in train['times']])} ms), "
          f"{train_audio_s / step_ms * 1e3:.1f} audio-s trained a second; peak device memory "
          f"{train['peak_mib']:.1f} MiB above the state's parameters")

    # 8. S2ST: the streaming translation session of cli simulate, checked
    # and timed before any trace
    inf = build_s2st_inference()
    audio = SyntheticSpeechDataset(segment_samples=S2ST_AUDIO_SAMPLES, sample_rate=S2ST_SAMPLE_RATE)[0]
    twin = S2STInference(copy.deepcopy(inf.model).cpu(), copy.deepcopy(inf.code_vocoder).cpu(), inf.cfg)
    programs = _check_s2st_programs(inf, twin)
    del twin
    run = _s2st_session(inf, audio)
    _check_s2st_session(run)
    result, agent = run["result"], run["agent"]
    n_params = {"s2st": sum(p.numel() for p in inf.model.parameters()),
                "unit_vocoder": sum(p.numel() for p in inf.code_vocoder.parameters())}
    print(f"s2st: build_s2st_inference() fp32 (StreamSpeechConfig(), CodeVocoderConfig(); {n_params['s2st']} + "
          f"{n_params['unit_vocoder']} parameters, the seeded draw of the JAX package's initialisers), TF32 off; "
          "card vs CPU within 1e-4 of each output's peak: "
          + "; ".join(f"{k} {e:.3g} (tol {t:.3g})" for k, (e, t) in programs.items())
          + f"; session over {S2ST_AUDIO_SAMPLES / S2ST_SAMPLE_RATE:g} s of synthetic speech in {S2ST_SEGMENT_MS} ms "
          f"segments: {len(result.outputs)} writes ({run['mid_stream_writes']} before the source ended), "
          f"{len(agent.committed_text_ids)} text tokens, {len(agent.emitted_units)} units, {len(result.waveform)} "
          f"output samples (peak {float(np.abs(result.waveform).max()):.3g}, rms "
          f"{float(np.sqrt(np.mean(np.square(result.waveform)))):.3g}), Average Lagging {result.average_lagging_ms:.1f} ms (computation-unaware), "
          f"{run['policy_calls']} policy calls; source buckets {sorted(run['source_buckets'])}, unit buckets "
          f"{sorted(run['unit_buckets'])}; KV-cached continuation equals uncached at the first write "
          f"({run['cached_vs_uncached'][0]}); GRC-kernel launches {run['launches']}")
    s2st_timing = _time_s2st(inf, audio, run)
    print(f"timing_s2st: session {s2st_timing['session_wall_s']:.3f} s wall for "
          f"{S2ST_AUDIO_SAMPLES / S2ST_SAMPLE_RATE:g} s of source, real-time factor {s2st_timing['rtf']:.4f} "
          f"(compute-aware); peak device memory {s2st_timing['peak_mib']:.1f} MiB above the models; median wall ms "
          "a call: " + json.dumps({k: round(v, 3) for k, v in s2st_timing["programs_ms"].items()}))

    # 9. traces: where the device time goes, in the forward, the cloning call,
    # a train step and an S2ST session.  Last, after every timing: once the
    # profiler has traced the card, the host's launches may stay slower.
    with torch.no_grad():
        print("trace: " + json.dumps(_trace(lambda: model(mel, spk, emo))))
        print("trace: " + json.dumps({"call": "cloning", **_trace(lambda: vocoder(mel, reference_mel=ref))}))
    _reset_launches()
    train_trace = _trace(lambda: train["step"](train["state"], train["gen"]), calls=TRACED_TRAIN_STEPS)
    if any(grc_kernel.launches.values()):
        raise AssertionError(f"the traced train steps launched the GRC kernels {grc_kernel.launches}")
    print("trace: " + json.dumps({"call": "train_step", **train_trace}))
    with torch.no_grad():
        s2st_trace = _trace(lambda: run_streaming_session(S2STAgent(inf), audio, sample_rate=S2ST_SAMPLE_RATE,
                                                          segment_size_ms=S2ST_SEGMENT_MS), calls=1)
    s2st_trace["launches_per_policy_call"] = s2st_trace["launches_per_call"] / run["policy_calls"]
    print("trace: " + json.dumps({"call": "s2st_session", **s2st_trace}))
    with torch.no_grad():
        after_ms = _time_ms(lambda: model(mel, spk, emo))
    print(f"timing_after_trace: the bf16 forward again, after the profiler: {after_ms:.3f} ms (before it, "
          f"phase 5: {fwd_ms[torch.bfloat16]:.3f} ms)")

    kernels = []
    for name, source, dtype in (("grc_step_bf16", "hifigan_tpu_torch/csrc/grc_step_bf16.cu", torch.bfloat16),
                                ("grc_step_f32", "hifigan_tpu_torch/csrc/grc_step.cu", torch.float32)):
        dtype_rows = rows[dtype]
        bytes_total = sum(r["bytes_ms"] for r in dtype_rows)
        ops_total = sum(r["ops_ms"] for r in dtype_rows)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "hifigan_tpu/ops/pallas/grc_kernel.py:176",
            "launches": launches[name],
            "max_abs_err": worst[dtype][0],
            "ms": sum(r["ms"] for r in dtype_rows),
            "plain_ms": sum(r["plain_ms"] for r in dtype_rows),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in dtype_rows),
            "bound_by": "bytes" if bytes_total >= ops_total else "operations",
            "library_ms": sum(r["library_ms"] for r in dtype_rows),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
