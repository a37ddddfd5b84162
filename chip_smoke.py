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
  9. evaluation: `cli eval` and `cli eval-clone` through cli.main, fp32,
     TF32 turned on before each command (which must turn it off), over files written to a temporary directory (a train-state
     checkpoint of create_train_state(TrainConfig()) with the generator
     redrawn, the judge encoders at EncoderTrainConfig() widths and a CTC
     judge at runs/asr_judge's config, both seeded): cli eval over 4
     held-out formant clips padded to one length, 9 grc_step_f32 launches a
     synthesis call, the report's keys JAX's, the judge's gate and ASR-BLEU
     status consistent, sample 0's metrics on the card against a CPU copy,
     the synthesis kernel path against the plain path; cli eval-clone at 4
     speakers x 2 contents (24 transfer pairs, 24 ablation calls), 9
     launches a cloning call, JAX's keys, the kernel path against the plain
     path at one pair and a zero reference moving the waveform; the
     synthesis's and the cloning call's median time, the evaluator's
     processing time and audio-seconds a second, both commands' wall time;
 10. HMT: the simultaneous beam search and `cli eval-s2st` at the widths
     of the JAX package's trained runs/s2st3 (d 256, 6 + 3 layers, 4 heads,
     vocab 32, chunk 8, with the transition head) and runs/unit_vocoder
     (HiFi-GAN V1 at 512, embed 128), seeded, fp32, TF32 off: the beam and
     HMT programs on the card against a CPU copy within 1e-4 of each
     output's peak (_hmt_prefill, a KV step at 16 rows under each gate,
     _decode_scores_hmt, _prefill_lp and a _beam_step); continue_text_hmt
     under each gate, a call and its resumption, equal on the card and the
     CPU where the decisions' margins allow; cli eval-s2st through cli.main
     over 2 held-out utterances and four text policies (JAX's report keys,
     finite F1 and AL, the seeded judge failing its gate, no GRC launch);
     then the wall time and real-time factor of an HMT session of each
     gate over the S2ST phase's 5 s of source, the KV HMT step's and the
     beam step's median time, the command's wall time and peak memory;
 11. training pipeline: `cli train-encoders` at EncoderTrainConfig()
     (ECAPA-TDNN 512, Emotion2Vec 3 x 256 x 4 heads, 32 x 16384 samples a
     step, fp32) for 2 + 3 steps from the seeded state (finite losses,
     parameters that change, no GRC launch, encoders.pt written and read
     back); one fp32 encoder step on the card against the CPU at batch 4
     (losses within 1e-4 relative; gradients within 2e-2 of each leaf's
     peak and 1e-2 in L2: ReLU decisions flip within the devices' fp32
     difference, PIPE_GRAD_FRAC says more); `cli train-clone --bf16` at TrainConfig() with the extractor at
     the encoders' widths (16 x 8192-sample pairs, 16384-sample references)
     grafting step 1's encoders, the identity hinge of its frozen judge, for
     2 + 3 steps logged each (finite losses, the probe's probe_eval_cos and
     probe_verified, no GRC launch in a train step and 9 grc_step_bf16 a
     probe call, the probe's kernel path against its plain path); one
     identity_finetune step (the trunk bit for bit, extractor and FiLM
     parameters moved); `cli train --dataset formant --device_data --bf16`
     for 2 steps; each step's CUDA-event time as the commands run it,
     audio-seconds trained a second and peak memory.  Only counts are cut:
     2 utterances a speaker, 2 contents, 16 formant utterances, the steps.
     Every cli.main call of phases 9-12 runs with TF32 turned on before it
     and must leave it off;
 12. training runs: `cli train-unit-vocoder` at UnitVocoderTaskConfig()
     (runs/unit_vocoder's code config: HiFi-GAN V1 at 512, embed 128; 8 x
     16-unit windows = 8 x 65,536 samples a step, fp32) for 2 + 3 steps from
     the seeded state (finite losses, parameters that change, no GRC launch,
     code_config.json and the last <step>.pt written), then 2 steps with
     --bf16 (finite losses); one fp32 unit-vocoder step on the card against
     the CPU at 1 x 4 units (16,384 samples, the CLI's loss weights with the
     STFT term); `cli train-s2st --eval_samples 8` at small_config() (d 256,
     6 + 3 layers, the transition head; 16 x 4 s a step) for 2 + 3 steps
     (finite losses, transition_acc in [0, 1], parameters that change, no
     GRC launch, s2st_eval.json with JAX's keys); one fp32 S2ST step on the
     card against the CPU at batch 2 on given draws (losses within 1e-4,
     gradients as phase 11 holds them); `cli eval-s2st --checkpoint_dir
     --unit_vocoder` over both run directories (JAX's keys, no GRC
     launch); `cli info` (the generator's parameter count); each step's
     CUDA-event time as the commands run it, audio-seconds trained a second,
     peak memory and each command's wall.  Only counts are cut: 16 and 32
     bank utterances (two batches' worth; JAX 256 and 512), 8 held-out
     utterances (JAX 32), the steps;
 13. traces: torch.profiler over 10 forwards of the kernel path, 10 cloning
     calls, 3 train steps, one S2ST session, one HMT session (learned gate),
     10 of eval-clone's cloning calls, one cloning train step (train-clone's,
     identity hinge included), one unit-vocoder train step and one S2ST
     train step: the device's busy share of the
     window, launches per call (and per policy call of the sessions), the
     call's peak device memory and device time per kernel family
     (attention, the convolutions' backward, FFT and the optimiser each its
     own), and the device time inside the extractor's and attention's
     profiler ranges; then 10 synth calls of the serving phase's vocoder
     route ("serving_synth"); then the bf16 forward's wall time again;
 14. serving (run before the traces): the app's StdlibServer, what `cli
     serve` runs without FastAPI, on port 0 in the background over an engine
     built with vocoder_checkpoint set to a seeded create_train_state(
     TrainConfig()) checkpoint written by CheckpointManager, its TTS
     routing mels through make_vocoder_synth in bf16; the machine has no HF weights (none are fetched), so ASR
     and MT degrade and
     SpeechT5's text -> mel stage is given a seeded [256, 80] mel.  Over
     HTTP: /api/health, /api/models/info (uses_framework_vocoder true),
     /api/translate/text (the identity fallback), /api/synthesize/text,
     whose WAV must decode to the direct synth's within one 16-bit PCM step;
     a synth call and a synthesis request each launch grc_step_bf16 9 times;
     the synth's kernel path against its plain path at phase 4's bf16
     tolerance; each of the synth's 9 kernel steps on the path's own inputs
     at [1, 65536, 32] bf16, and phase 3's seeded steps at that shape,
     against the plain step with phase 3's limits, which must refuse the
     step with its MRF taps zeroed on each; the synth call's median time (CUDA events, 25 after
     warm-up) and a request's wall;
 15. parallelism (run before the traces), over an NCCL group of one rank
     (NCCL places one rank on a card), destroyed at the end:
     make_sharded_train_step over make_mesh(1, 1) at phase 7's TrainConfig()
     bf16 16 x 8192 steps, 2 + 3 steps with losses equal to the plain
     step's and two gradient all-reduces a step, then both steps' median
     time over 10 after 2, alternating;
     the sequence-parallel StreamSpeechConfig() encoder over 4,096 frames
     (fp32) within 1e-4 of the peak of ChunkedConformer(chunked=True), both
     wall times; `python -m torch.distributed.run --standalone
     --nproc_per_node 1 -m hifigan_tpu_torch.cli train --bf16 --dataset
     formant --device_data --max_steps 2` exits 0 with the metrics of the
     command without the launcher; dryrun_multichip(1) on the card, and
     dryrun_multichip(4, device="cpu"), four gloo processes on the card
     machine's CPU (a check of its torch.distributed, not a timing).
 16. bench (run before the traces): `cli bench` through cli.main, as a user
     runs it, TF32 turned on before it: the root bench.py's five configs at
     its shapes (the flagship, HiFi-GAN V1 and the cloning vocoder with its
     embeddings extracted from the mel, bf16 at 8 x 256 frames; the GAN
     train step at 4 x 8192 and the production step at 16 x 8192, 32 steps
     a call from a 64-utterance formant bank on the card), timed by the
     command's CUDA events; one stdout line with the JAX command's four
     keys (a finite value above 0, vs_baseline = round(value / 50, 2)), a
     stderr record of the five configs with no error and vs_prev_round
     null, grc_step_bf16 launched 9 times a call of the flagship and the
     conditioned configs, grc_step_f32 by none, and no GRC kernel by
     HiFi-GAN V1 or the train steps.
Then one JSON line describing the kernels, and last the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from dataclasses import replace

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
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.app.audio import float_to_wav_bytes, wav_bytes_to_float
from hifigan_tpu_torch.app.config import Settings
from hifigan_tpu_torch.app.engine import make_vocoder_synth
from hifigan_tpu_torch.app.offline import OfflineManager
from hifigan_tpu_torch.app.server import StdlibServer
from hifigan_tpu_torch.eval.cloning_eval import EVAL_CONTENT_BASE, EVAL_REF_BASE, _pad
from hifigan_tpu_torch.eval.evaluator import StreamEvaluator
from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.ops.cuda import build, grc_kernel
from hifigan_tpu_torch.ops.grc_lora import group_stats
from hifigan_tpu_torch.streaming import incremental as inc
from hifigan_tpu_torch.streaming import run_streaming_session
from hifigan_tpu_torch.streaming import runtime as s2st_runtime
from hifigan_tpu_torch.streaming.agents import S2STAgent, S2TTAgent
from hifigan_tpu_torch.streaming.harness import TextSegment
from hifigan_tpu_torch.streaming.runtime import UNIT_BUCKETS, S2STInference, S2STInferenceConfig, _bucket
from hifigan_tpu_torch.train import audio_to_mel, make_eval_step, make_train_step
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.train.data import SyntheticSpeechDataset
from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus
from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler
from hifigan_tpu_torch.train.cloning import (
    build_cloning_banks,
    is_conditioning,
    make_cloning_train_step,
    make_pair_sampler,
)
from hifigan_tpu_torch.train.s2st_task import S2STTaskConfig
from hifigan_tpu_torch.train.unit_vocoder import UnitVocoderTaskConfig
from hifigan_tpu_torch.train.encoder_pretrain import (
    EncoderTrainConfig,
    build_labelled_bank,
    build_models,
    create_encoder_state,
    make_encoder_sampler,
    make_encoder_train_step,
)
from hifigan_tpu_torch.weights import (
    load_encoder_checkpoint,
    read_s2st_step,
    save_ctc_judge,
    save_encoder_checkpoint,
    save_s2st_checkpoint,
)

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
# The evaluation phase: cli eval over 4 held-out formant clips and cli
# eval-clone's grid at 4 speakers x 2 contents (24 transfer pairs and 24
# ablation calls), fp32 at TrainConfig() widths.  The CTC judge is seeded at
# the config of the JAX package's runs/asr_judge/streamspeech_config.json.
EVAL_SAMPLES, EVAL_CLONE_SPEAKERS, EVAL_CLONE_CONTENTS = 4, 4, 2
JUDGE_CONFIG = dict(input_dim=80, hidden_dim=256, encoder_layers=6, decoder_layers=3, num_heads=4, vocab_size=32,
                    unit_vocab_size=32, chunk_size=8, speaker_dim=192, emotion_dim=256, vocoder_hidden=128,
                    vocoder_upsample=(8, 8, 2, 2), ecapa_channels=64, emo_hidden=64, emo_layers=1)
# The keys of the JAX package's reports (hifigan_tpu/cli.py cmd_eval with
# --dataset formant, and cmd_eval_clone without --full_pairs).
EVAL_REPORT_KEYS = {"num_samples", "raw_results", "statistics", "benchmarks", "dataset", "checkpoint_dir",
                    "restored_step", "sim_encoders", "asr_judge_gate"}
EVAL_RESULT_KEYS = {"speaker_similarity", "emotion_similarity", "mel_l1", "mcd", "processing_time", "rtf"}
EVAL_CLONE_REPORT_KEYS = {"n_transfer_pairs", "transfer_verified_rate", "transfer_closer_to_target_rate",
                          "transfer_sim_target_mean", "transfer_sim_source_mean", "mel_l1_to_target_rendition_mean",
                          "mel_l1_to_source_rendition_mean", "ablation", "encoder_separation", "checkpoint_dir",
                          "restored_step", "encoder_step"}
# The HMT phase: cli eval-s2st's stack at the widths of the JAX package's
# trained runs/s2st3 (its streamspeech_config.json is runs/asr_judge's,
# JUDGE_CONFIG; the S2ST trainer's tree, with the transition head) and
# runs/unit_vocoder (code_config.json: HiFi-GAN V1 at 512), seeded, with
# eval-s2st's S2STInferenceConfig(max_target_len=64).  The program checks at
# continue_text_hmt's 4 beams x 4 read candidates (16 rows), the beam step at
# 5 rows; cli eval-s2st over 2 held-out utterances and its four text
# policies without wait-k (the JAX package's WaitkS2TTAgent has no
# end-of-buffer stop, and a seeded decoder writes no EOS: ROADMAP Queue 3).
S2ST3_CONFIG = JUDGE_CONFIG
UNIT_VOCODER_CONFIG = dict(unit_vocab_size=32, embed_dim=128, upsample_factors=(8, 8, 2, 2), hidden_channels=512,
                           max_duration_per_unit=16, speaker_dim=0, dur_prediction=True, f0=False, f0_quant_bins=0)
HMT_MAX_TARGET_LEN, HMT_BEAM, HMT_CANDS, HMT_BEAM_STEP_ROWS = 64, 4, 4, 5
HMT_SAMPLES, HMT_POLICIES = 2, ("offline_greedy", "stride1_greedy", "hmt_confidence", "hmt_learned")
EVAL_S2ST_REPORT_KEYS = {"checkpoint_dir", "restored_step", "policies", "asr_judge"}
HMT_WRITE_THRESHOLD = 0.5  # continue_text_hmt's default

# The training-pipeline phase: cli train-encoders at EncoderTrainConfig()
# (ECAPA-TDNN 512, Emotion2Vec 3 x 256 x 4 heads, 32 x 16384 samples a step,
# fp32), cli train-clone at TrainConfig() with the extractor at those widths
# (16 x 8192-sample pairs, 16384-sample references, bf16, the identity
# hinge), one identity_finetune step and cli train --dataset formant
# --device_data (16 x 8192, bf16).  Counts cut for the time limit only: the
# labelled bank's utterances per speaker (JAX 12), the cloning banks'
# contents (JAX 32), the formant dataset's size (JAX 512) and the steps.
PIPE_UTTERANCES, PIPE_CONTENTS, PIPE_DATASET_SIZE = 2, 2, 16
PIPE_WARMUP, PIPE_TIMED, PIPE_FORMANT_STEPS = 2, 3, 2
PIPE_CHECK_BATCH = 4  # the fp32 encoder step, card against CPU
# A judge trained 5 steps maps every clip to nearly one embedding (cosines
# near 1): at JAX's margin 0.8 the hinge would be silent, at 1.0 its
# gradient runs through the judge in every step.
PIPE_IDENTITY_MARGIN = 1.0
# The fp32 encoder step's gradients, card against CPU.  The losses agree to
# 1e-7, but the two devices' fp32 forwards differ by about 1e-5 of each
# activation's peak (cuBLAS and cuDNN against the CPU's summation order), and
# a ReLU whose input lies within that difference passes a gradient on one
# device and not on the other: at the seeded draw ECAPA-TDNN's zero-bias
# ReLUs flip, and the leaves behind them differ by up to 0.77% of their peak
# and 0.29% in L2 (measured, NVIDIA H100 80GB HBM3, 700 W, two seeds; more
# than half the leaves above 1e-4 of their peak).  So each leaf is held to
# PIPE_GRAD_FRAC of its peak and PIPE_GRAD_L2 in L2, the ZERO_GRADIENT
# leaves (rounding noise) to PIPE_ZERO_FLOOR of the model's peak.
PIPE_GRAD_FRAC, PIPE_GRAD_L2, PIPE_GRAD_FLOOR, PIPE_ZERO_FLOOR = 2e-2, 1e-2, 1e-7, 1e-6
ZERO_GRADIENT = ("asp.att2.bias", ".mha.k.bias")  # a bias before a softmax along which it is constant

# The training-runs phase: cli train-unit-vocoder at UnitVocoderTaskConfig()
# (runs/unit_vocoder's code config: HiFi-GAN V1 at 512, embed 128, 16 frames a
# unit at most; windows of 16 units = 65,536 samples, batch 8; fp32, then
# --bf16) and cli train-s2st at small_config() (runs/s2st3's: d 256, 6 + 3
# layers, 4 heads, vocab 32, chunk 8, the transition head; batch 16 x 4 s =
# 400 frames; fp32) with the held-out token F1, then cli eval-s2st over both
# run directories and cli info.  Counts cut for the time limit only: the
# banks' utterances (JAX 256 and 512; here two batches' worth), the held-out
# set (JAX 32) and the steps.  The card-vs-CPU steps: the unit vocoder at 1
# row x 4 units (16,384 samples) with the CLI's loss weights, the STFT term
# included; the S2ST model at batch 2 on given draws (one prefix-masked row).
RUNS_UV_DATASET, RUNS_S2ST_DATASET, RUNS_EVAL_SAMPLES = 16, 32, 8
RUNS_WARMUP, RUNS_TIMED, RUNS_BF16_STEPS = 2, 3, 2
RUNS_UV_CHECK_UNITS = 4
RUNS_S2ST_DRAW = {"idx": [0, 1], "use_prefix": [True, False], "frac": [0.6, 0.9]}
S2ST_EVAL_KEYS = {"token_f1", "exact_match", "n", "step"}  # the JAX package's s2st_eval.json

# The parallel phase: the sharded GAN step at phase 7's shape over a mesh of
# one card, 2 + 3 steps against the plain step; the sequence-parallel
# StreamSpeechConfig() encoder over 4,096 frames; cli train under the
# launcher and without it over a small formant corpus.
PARALLEL_WARMUP, PARALLEL_STEPS, PARALLEL_TIMED, SP_FRAMES, PARALLEL_CORPUS = 2, 3, 10, 4096, 64

# The eval sample's metrics on the card against the CPU (TF32 off; the card
# runs the fp32 kernel, the CPU the plain chain): SIM is a cosine of unit
# embeddings; mel-L1 and MCD are relative to their value.
EVAL_SIM_TOL, EVAL_REL_TOL = 1e-4, 1e-3


def _cli(argv: list) -> None:
    """``cli.main(argv)`` as a user runs it: TF32 on in cuDNN and cuBLAS
    first (cuDNN's is PyTorch's default), and the command must leave both
    off, so that the checks of its fp32 results see TF32 if the command
    ever ran with it."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cli.main(argv)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"cli {argv[0]} left TF32 on (cuDNN {torch.backends.cudnn.allow_tf32}, cuBLAS "
                             f"{torch.backends.cuda.matmul.allow_tf32})")


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


def _no_taps(pre, mean, inv, gamma, beta, w, bias, slope, *, lo, dilation):
    """The plain GRC step with the conv taps zeroed: a path that drops the
    MRF taps, which a kernel check must be able to tell apart."""
    return grc_kernel.grc_step_reference(pre, mean, inv, gamma, beta, torch.zeros_like(w), bias, slope,
                                         lo=lo, dilation=dilation)


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


def _n_steps(cfg: TrainConfig) -> int:
    """GRC steps a synthesis call: 9 at ``GeneratorConfig()``."""
    return sum(len(d) for d in cfg.generator.resblock_dilations)


def _write_eval_files(directory: str) -> dict:
    """The files ``cli eval`` and ``cli eval-clone`` read, in ``directory``:
    a train-state checkpoint of ``create_train_state(TrainConfig())`` in
    fp32 (the generator redrawn by ``_redraw_parameters``: at the JAX
    initialisers' draw its output is nearly silent and its log-mel sits on
    the floor, where no metric could see the synthesis; the extractor keeps
    that draw, as in phase 6), the judge encoders at ``EncoderTrainConfig()``
    widths and the CTC judge at JUDGE_CONFIG, both seeded."""
    state = create_train_state(TrainConfig(), torch.float32, "cuda", seed=0)
    _redraw_parameters(state.vocoder.generator, seed=8)
    paths = {"ckpt": f"{directory}/ckpt", "encoders": f"{directory}/encoders.pt", "judge": f"{directory}/judge.pt"}
    if not CheckpointManager(paths["ckpt"]).save(state, force=True):
        raise AssertionError("the evaluation's train-state checkpoint was not written")
    ecfg = EncoderTrainConfig()
    save_encoder_checkpoint(paths["encoders"], ecfg, *build_models(ecfg, gen=torch.Generator().manual_seed(9)))
    judge = StreamSpeechS2ST(StreamSpeechConfig(**JUDGE_CONFIG), gen=torch.Generator().manual_seed(10),
                             with_vocoder=False)
    save_ctc_judge(paths["judge"], judge)
    return {"vocoder": state.vocoder.eval(), **paths}


def _eval_samples(cfg: TrainConfig, device: str) -> list:
    """``cli eval``'s formant samples: the clips, padded to one shared
    length, as mels on ``device`` with their valid frames."""
    corpus = FormantSpeechCorpus(n_speakers=8)
    clips = [corpus.utterance(i % 8, 10_000 + i) for i in range(EVAL_SAMPLES)]
    seg = -(-max(len(c) for c in clips) // 1024) * 1024
    samples = []
    for clip in clips:
        audio = np.zeros(seg, np.float32)
        audio[: len(clip)] = clip
        with torch.no_grad():
            mel = audio_to_mel(torch.from_numpy(audio[None]).to(device), cfg)
        samples.append({"mel": mel, "valid_frames": -(-len(clip) // cfg.mel.hop_length)})
    return samples


def _check_eval(files: dict, directory: str) -> dict:
    """``cli eval`` on the card, through ``cli.main`` as a user runs it,
    over EVAL_SAMPLES held-out formant clips with the files of
    ``_write_eval_files``.

    - Launches, counted from 0 just before the command: 9 ``grc_step_f32``
      a synthesis call (EVAL_SAMPLES calls and one untimed warm-up), no
      ``grc_step_bf16``.
    - The report: JAX's keys, each sample's metric keys, finite metrics,
      trained encoders; the judge's gate report, and ASR-BLEU SKIPPED
      exactly when no judge passed it.
    - Sample 0's metrics on the card against a CPU copy of the same files
      (``StreamEvaluator`` over the CPU's mel of the same clip): SIM within
      EVAL_SIM_TOL, mel-L1 and MCD within EVAL_REL_TOL of their value.
    - The synthesis on the kernel path against the plain path on the card,
      at sample 0: 1e-4 (the fp32 generator phase's tolerance)."""
    out = f"{directory}/eval.json"
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its summary line; the report is the file
        _cli(["eval", "--device", "cuda", "--checkpoint_dir", files["ckpt"], "--encoders", files["encoders"],
                  "--asr", files["judge"], "--samples", str(EVAL_SAMPLES), "--output", out])
    wall_s = time.perf_counter() - t0
    launches = dict(grc_kernel.launches)
    expect = {"grc_step_f32": _n_steps(TrainConfig()) * (EVAL_SAMPLES + 1), "grc_step_bf16": 0}
    if launches != expect:
        raise AssertionError(f"cli eval launched the kernels {launches} times, expected {expect}: 9 grc_step_f32 "
                             f"a synthesis call, {EVAL_SAMPLES} calls and one warm-up")
    with open(out) as f:
        report = json.load(f)
    if set(report) != EVAL_REPORT_KEYS or any(set(r) != EVAL_RESULT_KEYS for r in report["raw_results"]):
        raise AssertionError(f"the eval report's keys {sorted(report)} / {[sorted(r) for r in report['raw_results']]} "
                             f"are not JAX's {sorted(EVAL_REPORT_KEYS)} / {sorted(EVAL_RESULT_KEYS)}")
    if report["num_samples"] != EVAL_SAMPLES or report["sim_encoders"] != "trained":
        raise AssertionError(f"the eval report has {report['num_samples']} samples, SIM encoders "
                             f"{report['sim_encoders']!r}")
    if not all(math.isfinite(v) for r in report["raw_results"] for v in r.values()):
        raise AssertionError(f"non-finite eval metrics: {report['raw_results']}")
    gate = report["asr_judge_gate"]
    candidate = gate["candidates"][0] if len(gate["candidates"]) == 1 else {}
    if "ground_truth_cer" not in candidate or candidate["dir"] != files["judge"]:
        raise AssertionError(f"the judge gate did not score the judge: {gate}")
    status = report["benchmarks"]["asr_bleu"]["status"]
    if (status == "SKIPPED") != (gate["selected"] is None):
        raise AssertionError(f"ASR-BLEU is {status} with the gate's selection {gate['selected']}")

    cfg = TrainConfig()
    cpu_state = CheckpointManager(files["ckpt"]).restore(create_train_state(cfg, torch.float32, "cpu", seed=0))
    cpu_vocoder = cpu_state.vocoder.eval()
    _, ecapa, emo, _ = load_encoder_checkpoint(files["encoders"], "cpu")
    no_grad = torch.no_grad()
    evaluator = StreamEvaluator(no_grad(lambda m: cpu_vocoder(m)["waveform"]), no_grad(lambda m: ecapa(m)),
                                no_grad(lambda m: emo(m)), no_grad(lambda w: audio_to_mel(w, cfg)))
    sample = _eval_samples(cfg, "cpu")[0]
    cpu = evaluator.evaluate_single_sample(sample["mel"], valid_frames=sample["valid_frames"])
    card = report["raw_results"][0]
    errs = {k: abs(card[k] - cpu[k]) for k in ("speaker_similarity", "emotion_similarity", "mel_l1", "mcd")}
    tols = {k: EVAL_SIM_TOL if "similarity" in k else EVAL_REL_TOL * abs(cpu[k]) for k in errs}
    if any(errs[k] > tols[k] for k in errs):
        raise AssertionError(f"eval sample 0 on the card {card} differs from the CPU's {cpu}: errors {errs}, "
                             f"tolerances {tols}")
    del cpu_state, cpu_vocoder

    vocoder = files["vocoder"]
    mel = _eval_samples(cfg, "cuda")[0]["mel"]
    with torch.no_grad():
        wav = vocoder(mel)["waveform"]
        plain = vocoder(mel, step=grc_kernel.grc_step_reference)["waveform"]
    kernel_err = float((wav - plain).abs().max())
    if kernel_err > 1e-4 or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"the eval synthesis on the kernel path differs from the plain path by {kernel_err:.3g}")
    return {"report": report, "launches": launches, "wall_s": wall_s, "errs": errs, "tols": tols,
            "kernel_err": kernel_err, "mel": mel, "cer": candidate["ground_truth_cer"], "status": status}


def _check_eval_clone(files: dict, directory: str) -> dict:
    """``cli eval-clone`` on the card, through ``cli.main``, at
    EVAL_CLONE_SPEAKERS x EVAL_CLONE_CONTENTS.

    - Launches, counted from 0 just before the command: 9 ``grc_step_f32``
      for each of the grid's cloning calls (S·(S−1)·C transfer pairs and
      3·S·C ablation calls), no ``grc_step_bf16``.
    - The report: JAX's keys, S·(S−1)·C transfer pairs, finite numbers.
    - At one pair (speaker 0's held-out content cloned from speaker 1's
      reference, the grid's shapes): the cloning call on the kernel path
      against the plain path, 1e-4; a zero reference in place of the right
      one moves the waveform by more than that tolerance (the conditioning
      path is live)."""
    out = f"{directory}/eval_clone.json"
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its summary; the report is the file
        _cli(["eval-clone", "--device", "cuda", "--checkpoint_dir", files["ckpt"], "--encoders",
                  files["encoders"], "--n_speakers", str(EVAL_CLONE_SPEAKERS), "--n_contents",
                  str(EVAL_CLONE_CONTENTS), "--output", out])
    wall_s = time.perf_counter() - t0
    launches = dict(grc_kernel.launches)
    s, c = EVAL_CLONE_SPEAKERS, EVAL_CLONE_CONTENTS
    calls = s * (s - 1) * c + 3 * s * c
    if launches != {"grc_step_f32": _n_steps(TrainConfig()) * calls, "grc_step_bf16": 0}:
        raise AssertionError(f"cli eval-clone launched the kernels {launches} times, expected 9 grc_step_f32 for "
                             f"each of its {calls} cloning calls")
    with open(out) as f:
        report = json.load(f)
    if set(report) != EVAL_CLONE_REPORT_KEYS or report["n_transfer_pairs"] != s * (s - 1) * c:
        raise AssertionError(f"the eval-clone report's keys {sorted(report)} are not JAX's "
                             f"{sorted(EVAL_CLONE_REPORT_KEYS)}, or its pairs {report.get('n_transfer_pairs')} not "
                             f"{s * (s - 1) * c}")
    numbers = [v for v in report.values() if isinstance(v, float)] + list(report["ablation"].values())
    if not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"non-finite eval-clone numbers: {report}")

    cfg, corpus, vocoder = TrainConfig(), FormantSpeechCorpus(n_speakers=32), files["vocoder"]
    content = corpus.utterance(0, 0, content=EVAL_CONTENT_BASE)
    ref = corpus.utterance(1, 0, content=EVAL_REF_BASE + 1, arousal=corpus.content_arousal(EVAL_CONTENT_BASE))
    with torch.no_grad():
        content_mel = audio_to_mel(_pad(content, 32_768).cuda(), cfg)
        ref_mel = audio_to_mel(_pad(ref, 16_384).cuda(), cfg)
        wav = vocoder(content_mel, reference_mel=ref_mel)["waveform"]
        plain = vocoder(content_mel, reference_mel=ref_mel, step=grc_kernel.grc_step_reference)["waveform"]
        zero = vocoder(content_mel, reference_mel=torch.zeros_like(ref_mel))["waveform"]
    kernel_err, moved = float((wav - plain).abs().max()), float((zero - wav).abs().max())
    if kernel_err > 1e-4:
        raise AssertionError(f"the eval-clone call on the kernel path differs from the plain path by {kernel_err:.3g}")
    if moved <= 1e-4:
        raise AssertionError(f"a zero reference moves the cloned waveform by {moved:.3g}, within the tolerance 1e-4: "
                             "the conditioning path is not live")
    return {"report": report, "launches": launches, "calls": calls, "wall_s": wall_s, "kernel_err": kernel_err,
            "moved": moved, "content_mel": content_mel, "ref_mel": ref_mel}


@contextlib.contextmanager
def _timed_steps(module, factory: str, record: list):
    """Wrap ``module.factory`` so that every step it makes records its
    CUDA-event time, the GRC launches inside it, the state it ran on, the
    step itself and its other arguments, as the commands that build their
    step through it run it."""
    real = getattr(module, factory)

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(state, *a, **kw):
            before = dict(grc_kernel.launches)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, *a, **kw)
            end.record()
            end.synchronize()
            record.append({"ms": start.elapsed_time(end), "state": state, "step": step, "args": a,
                           "launches": {k: v - before[k] for k, v in grc_kernel.launches.items()}})
            return out

        return timed

    setattr(module, factory, make)
    try:
        yield
    finally:
        setattr(module, factory, real)


def _metrics_rows(directory: str) -> list:
    with open(f"{directory}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _check_encoder_step_on_cpu(bank: tuple) -> dict:
    """One fp32 encoder step of EncoderTrainConfig() at PIPE_CHECK_BATCH on
    the card against the same step on the CPU, from the same seeded state
    on the same crops, TF32 off (as the CLI left it): every loss within 1e-4
    relative, the accuracies equal, every gradient within PIPE_GRAD_FRAC of
    its leaf's max |g| plus PIPE_GRAD_FLOOR of its model's and within
    PIPE_GRAD_L2 of its leaf's norm (the ZERO_GRADIENT leaves: within
    PIPE_ZERO_FLOOR of the model's max |g|).  Also counted: the leaves whose
    worst error is above 1e-4 of their peak."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on before the fp32 encoder check")
    cfg = replace(EncoderTrainConfig(), batch_size=PIPE_CHECK_BATCH)
    states = {dev: create_encoder_state(cfg, torch.float32, dev, seed=1) for dev in ("cuda", "cpu")}
    audio, lengths, speakers, bins = bank
    batch = make_encoder_sampler(cfg, *(torch.from_numpy(a) for a in (lengths, speakers, bins)))(
        torch.Generator().manual_seed(2), torch.from_numpy(audio))
    metrics = {dev: {k: float(v) for k, v in make_encoder_train_step(
        cfg, torch.from_numpy(audio).to(dev), lengths, speakers, bins)(st, batch)[1].items()}
        for dev, st in states.items()}
    loss_err = max(abs(metrics["cuda"][k] - metrics["cpu"][k]) / max(abs(metrics["cpu"][k]), 1e-12)
                   for k in metrics["cpu"] if "loss" in k or "cos" in k)
    acc_equal = all(metrics["cuda"][k] == metrics["cpu"][k] for k in metrics["cpu"] if "acc" in k)
    worst = {"max_share": 0.0, "max_leaf": "", "l2": 0.0, "l2_leaf": "", "over_1e-4": 0, "leaves": 0}
    grad = lambda p: torch.zeros_like(p) if p.grad is None else p.grad  # noqa: E731  (the head's bias takes none)
    for model in ("ecapa", "emo"):
        cpu = {n: grad(p) for n, p in getattr(states["cpu"], model).named_parameters()}
        top = max(float(g.abs().max()) for g in cpu.values())
        for name, p in getattr(states["cuda"], model).named_parameters():
            want, err = cpu[name], grad(p).cpu() - cpu[name]
            peak, max_err = float(want.abs().max()), float(err.abs().max())
            worst["leaves"] += 1
            if name.endswith(ZERO_GRADIENT):
                if max_err > PIPE_ZERO_FLOOR * top:
                    raise AssertionError(f"{model}.{name}: gradient err {max_err:.3g} > {PIPE_ZERO_FLOOR} of {top:.3g}")
                continue
            share = max_err / (PIPE_GRAD_FRAC * peak + PIPE_GRAD_FLOOR * top)
            l2 = float(err.norm() / want.norm().clamp_min(1e-30))
            worst["over_1e-4"] += max_err > 1e-4 * peak
            if share > worst["max_share"]:
                worst.update(max_share=share, max_leaf=f"{model}.{name}", max_rel=max_err / max(peak, 1e-30))
            if l2 > worst["l2"]:
                worst.update(l2=l2, l2_leaf=f"{model}.{name}")
    if loss_err > 1e-4 or not acc_equal or worst["max_share"] > 1 or worst["l2"] > PIPE_GRAD_L2:
        raise AssertionError(f"the fp32 encoder step on the card differs from the CPU's: {metrics} (loss rel err "
                             f"{loss_err:.3g}), gradients {worst}")
    return {"loss_err": loss_err, "grads": worst, "metrics": metrics["cuda"]}


def _check_pipeline(directory: str) -> dict:
    """The voice-cloning training pipeline on the card, through ``cli.main``
    as a user runs it (TF32 turned on before each command, off after it).

    1. ``cli train-encoders`` at EncoderTrainConfig() for PIPE_WARMUP +
       PIPE_TIMED steps from the seeded state: every logged loss finite,
       no GRC launch, more than 90% of the parameter tensors changed,
       ``encoders.pt`` written and read back by ``load_encoder_checkpoint``.
    2. :func:`_check_encoder_step_on_cpu`.
    3. ``cli train-clone --bf16 --encoders <1's file> --identity_encoders
       <1's file> --identity_weight 1 --identity_margin
       PIPE_IDENTITY_MARGIN`` at TrainConfig() for PIPE_WARMUP +
       PIPE_TIMED steps, logging every step: finite losses,
       ``identity_loss`` among them and above 0, ``probe_eval_cos`` and
       ``probe_verified`` on every row; no GRC launch inside a train step
       and 9 ``grc_step_bf16`` launches for each probe call (counted from 0
       just before the command); the probe's waveforms on the kernel path
       within 4 bf16 ulps of the peak of the plain path's.
    4. One ``identity_finetune`` step (the centroid hinge) on that state:
       every parameter outside the extractor and the FiLM layers bit for
       bit as before; at least one extractor and one FiLM parameter moved.
    5. ``cli train --dataset formant --dataset_size PIPE_DATASET_SIZE
       --device_data --bf16`` for PIPE_FORMANT_STEPS steps: finite losses.
    The step times are CUDA events around each step as the commands run
    it; the probe, logging and checkpoints fall outside them."""
    import os

    from hifigan_tpu_torch.train import cloning as cloning_mod
    from hifigan_tpu_torch.train import encoder_pretrain as encoder_mod

    enc_dir, clone_dir, formant_dir = (f"{directory}/{d}" for d in ("encoders", "clone", "formant"))
    seeded = create_encoder_state(EncoderTrainConfig(), torch.float32, "cuda", seed=0)
    start = {m: {n: p.detach().clone() for n, p in getattr(seeded, m).named_parameters()} for m in ("ecapa", "emo")}
    del seeded
    enc_steps = []
    _reset_launches()
    t0 = time.perf_counter()
    with _timed_steps(encoder_mod, "make_fused_encoder_step", enc_steps):
        _cli(["train-encoders", "--device", "cuda", "--checkpoint_dir", enc_dir, "--utterances_per_speaker",
              str(PIPE_UTTERANCES), "--max_steps", str(PIPE_WARMUP + PIPE_TIMED), "--log_every", "1"])
    enc_wall = time.perf_counter() - t0
    enc_launches = dict(grc_kernel.launches)
    enc_rows = _metrics_rows(enc_dir)
    enc_state = enc_steps[-1]["state"]
    changed = {m: sum(not torch.equal(p.detach(), start[m][n]) for n, p in getattr(enc_state, m).named_parameters())
               for m in start}
    if (len(enc_rows) != PIPE_WARMUP + PIPE_TIMED or any(enc_launches.values())
            or not all(math.isfinite(v) for r in enc_rows for v in r.values())):
        raise AssertionError(f"cli train-encoders: rows {enc_rows}, GRC launches {enc_launches}")
    if any(n <= 0.9 * len(start[m]) for m, n in changed.items()):
        raise AssertionError(f"cli train-encoders changed only {changed} of {[len(v) for v in start.values()]} tensors")
    enc_cfg, _, _, enc_step = load_encoder_checkpoint(f"{enc_dir}/encoders.pt", "cuda")
    if enc_cfg != EncoderTrainConfig() or enc_step != PIPE_WARMUP + PIPE_TIMED:
        raise AssertionError(f"encoders.pt holds {enc_cfg} at step {enc_step}")
    enc_ms = [r["ms"] for r in enc_steps]
    del enc_state, enc_steps

    bank = build_labelled_bank(n_speakers=EncoderTrainConfig().n_speakers, utterances_per_speaker=PIPE_UTTERANCES)
    enc_check = _check_encoder_step_on_cpu(bank)

    clone_steps, probes = [], []
    real_probe = cloning_mod.CloningProbe

    class RecordedProbe(real_probe):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            probes.append(self)

    os.environ["HIFIGAN_TPU_CACHE"] = directory
    cloning_mod.CloningProbe = RecordedProbe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with _timed_steps(cloning_mod, "make_cloning_train_step", clone_steps):
            _cli(["train-clone", "--device", "cuda", "--bf16", "--checkpoint_dir", clone_dir, "--encoders",
                  f"{enc_dir}/encoders.pt", "--identity_encoders", f"{enc_dir}/encoders.pt", "--identity_weight", "1",
                  "--identity_margin", str(PIPE_IDENTITY_MARGIN), "--n_contents", str(PIPE_CONTENTS), "--max_steps", str(PIPE_WARMUP + PIPE_TIMED),
                  "--log_every", "1"])
    finally:
        cloning_mod.CloningProbe = real_probe
    torch.cuda.synchronize()
    clone_wall = time.perf_counter() - t0
    clone_peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    clone_launches = dict(grc_kernel.launches)
    clone_rows = _metrics_rows(clone_dir)
    n_steps = PIPE_WARMUP + PIPE_TIMED
    step_launches = [r["launches"] for r in clone_steps]
    if len(clone_rows) != n_steps or not all(
            {"identity_loss", "identity_cos", "probe_eval_cos", "probe_verified"} <= set(r) and r["identity_loss"] > 0
            and all(math.isfinite(v) for v in r.values()) for r in clone_rows):
        raise AssertionError(f"cli train-clone's metrics: {clone_rows}")
    if any(any(d.values()) for d in step_launches) or clone_launches != {"grc_step_bf16": 9 * n_steps,
                                                                        "grc_step_f32": 0}:
        raise AssertionError(f"cli train-clone launched the GRC kernels {clone_launches} ({step_launches} inside the "
                             f"train steps): expected none in the steps and 9 grc_step_bf16 in each of the "
                             f"{n_steps} probe calls")
    probe, state = probes[0], clone_steps[-1]["state"]
    wav = probe.waveform(state.vocoder)
    plain = probe.waveform(state.vocoder, step=grc_kernel.grc_step_reference)
    probe_err, probe_tol = float((wav - plain).abs().max()), 4 * 2.0 ** -8 * float(plain.abs().max())
    if probe_err > probe_tol or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"the probe's kernel path differs from its plain path by {probe_err:.3g} > {probe_tol:.3g}")

    # train-clone's config: its default loss weights (the STFT term on), the
    # extractor at the encoders' widths
    ecfg = EncoderTrainConfig()
    cfg = replace(TrainConfig(), loss_weights=replace(TrainConfig().loss_weights, multi_res_stft=1.0),
                  ecapa_channels=ecfg.ecapa_channels, emo_hidden=ecfg.emo_hidden, emo_layers=ecfg.emo_layers,
                  emo_heads=ecfg.emo_heads)
    content, ref, lengths = build_cloning_banks(n_speakers=32, n_contents=PIPE_CONTENTS,
                                                cache_path=cloning_mod.default_cache_path())
    os.environ.pop("HIFIGAN_TPU_CACHE")
    content, ref = torch.from_numpy(content).cuda(), torch.from_numpy(ref).cuda()
    sampler = make_pair_sampler(torch.from_numpy(lengths).cuda(), 8192, 16384, 16)
    finetune = make_cloning_train_step(cfg, sampler, identity_fn=probe.judge, identity_weight=1.0,
                                       identity_centroids=probe.centroids_seg, identity_finetune=True)
    before = {n: p.detach().clone() for n, p in state.vocoder.named_parameters()}
    _reset_launches()
    finetune(state, torch.Generator(device="cuda").manual_seed(3), content, ref)
    moved = {n for n, p in state.vocoder.named_parameters() if not torch.equal(p.detach(), before[n])}
    trunk = [n for n in before if not is_conditioning(n)]
    if (moved & set(trunk) or not any(n.startswith("embedding_extractor.") for n in moved)
            or not any("film_" in n for n in moved) or any(grc_kernel.launches.values())):
        raise AssertionError(f"identity_finetune moved trunk parameters {sorted(moved & set(trunk))[:5]} or no "
                             f"extractor / FiLM parameter ({len(moved)} moved)")
    del before

    _reset_launches()
    _cli(["train", "--device", "cuda", "--bf16", "--dataset", "formant", "--dataset_size", str(PIPE_DATASET_SIZE),
          "--device_data", "--max_steps", str(PIPE_FORMANT_STEPS), "--log_every", "1", "--checkpoint_dir",
          formant_dir])
    formant_rows = _metrics_rows(formant_dir)
    with open(f"{formant_dir}/training_summary.json") as f:
        summary = json.load(f)
    if (len(formant_rows) != PIPE_FORMANT_STEPS or summary["data"] != "formant" or any(grc_kernel.launches.values())
            or not all(math.isfinite(v) for r in formant_rows for v in r.values())):
        raise AssertionError(f"cli train --dataset formant: {formant_rows}, summary data {summary['data']}")
    return {"enc_rows": enc_rows, "enc_ms": enc_ms, "enc_wall": enc_wall,
            "changed": changed, "enc_check": enc_check, "clone_rows": clone_rows,
            "clone_ms": [r["ms"] for r in clone_steps], "clone_wall": clone_wall, "clone_peak_mib": clone_peak_mib,
            "clone_launches": clone_launches, "probe_err": probe_err, "probe_tol": probe_tol,
            "moved": len(moved), "trunk": len(trunk), "formant_rows": formant_rows, "state": state,
            "banks": (content, ref), "step": make_cloning_train_step(cfg, sampler, identity_fn=probe.judge, identity_weight=1.0,
                                            identity_centroids=probe.centroids_seg)}


def _hold_grads(pairs, what: str) -> dict:
    """Each ``(card_module, cpu_module)`` pair's gradients, card against CPU:
    every leaf within PIPE_GRAD_FRAC of its max |g| plus PIPE_GRAD_FLOOR of
    its module's, and within PIPE_GRAD_L2 of its norm; a leaf whose gradient
    is zero but for rounding (its peak under 1e-6 of the module's) within
    PIPE_ZERO_FLOOR of the module's.  ReLU and LeakyReLU decisions flip
    within the devices' fp32 difference (PIPE_GRAD_FRAC says more).  Returns
    the worst shares and the count of leaves above 1e-4 of their peak."""
    worst = {"max_share": 0.0, "max_leaf": "", "l2": 0.0, "l2_leaf": "", "over_1e-4": 0, "leaves": 0}
    for card, cpu in pairs:
        want = {n: p.grad for n, p in cpu.named_parameters()}
        top = max(float(g.abs().max()) for g in want.values())
        for name, p in card.named_parameters():
            err = p.grad.cpu() - want[name]
            peak, max_err = float(want[name].abs().max()), float(err.abs().max())
            worst["leaves"] += 1
            if peak < 1e-6 * top:
                if max_err > PIPE_ZERO_FLOOR * top:
                    raise AssertionError(f"{what} {name}: gradient err {max_err:.3g} > {PIPE_ZERO_FLOOR} of {top:.3g}")
                continue
            share = max_err / (PIPE_GRAD_FRAC * peak + PIPE_GRAD_FLOOR * top)
            l2 = float(err.norm() / want[name].norm().clamp_min(1e-30))
            worst["over_1e-4"] += max_err > 1e-4 * peak
            if share > worst["max_share"]:
                worst.update(max_share=share, max_leaf=name, max_rel=max_err / peak)
            if l2 > worst["l2"]:
                worst.update(l2=l2, l2_leaf=name)
    if worst["max_share"] > 1 or worst["l2"] > PIPE_GRAD_L2:
        raise AssertionError(f"the fp32 {what} step's gradients on the card differ from the CPU's: {worst}")
    return worst


def _loss_err(card: dict, cpu: dict, what: str) -> float:
    """The worst relative error of the card's metrics against the CPU's;
    raises above 1e-4."""
    err = max(abs(float(card[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-12) for k in cpu)
    if err > 1e-4:
        raise AssertionError(f"the fp32 {what} step's metrics on the card {card} differ from the CPU's {cpu}")
    return err


def _check_uv_step_on_cpu() -> dict:
    """One fp32 unit-vocoder step at UnitVocoderTaskConfig()'s code config
    on the card against the same step on the CPU: the same seeded state,
    one window of RUNS_UV_CHECK_UNITS units drawn from a two-utterance bank,
    cli train-unit-vocoder's loss weights (the STFT term included), TF32
    off: metrics within 1e-4 relative, gradients held by :func:`_hold_grads`."""
    from hifigan_tpu_torch.train import LossWeights
    from hifigan_tpu_torch.train import unit_vocoder as uv

    task = replace(uv.UnitVocoderTaskConfig(), n_utterances=2, window_units=RUNS_UV_CHECK_UNITS, batch_size=1)
    bank = {k: torch.from_numpy(v) for k, v in uv.build_unit_vocoder_bank(task).items()}
    batch = uv.make_unit_vocoder_sampler(task)(torch.Generator().manual_seed(1), bank)
    tcfg = TrainConfig(warmup_steps=1000, loss_weights=LossWeights(feature_matching=2.0, mel=45.0, multi_res_stft=1.0))
    states = {dev: uv.create_unit_vocoder_state(tcfg, task, torch.float32, dev, seed=1) for dev in ("cuda", "cpu")}
    metrics = {dev: uv.make_unit_vocoder_train_step(tcfg, task)(st, batch)[1] for dev, st in states.items()}
    err = _loss_err(metrics["cuda"], metrics["cpu"], "unit-vocoder")
    grads = _hold_grads([(states["cuda"].vocoder, states["cpu"].vocoder),
                         (states["cuda"].discriminators, states["cpu"].discriminators)], "unit-vocoder")
    return {"loss_err": err, "grads": grads, "samples": task.window_samples}


def _check_s2st_step_on_cpu() -> dict:
    """One fp32 S2ST step of small_config() at batch 2 on the card against
    the same step on the CPU: the same seeded state, the draw
    RUNS_S2ST_DRAW given (one prefix-masked row) over a two-utterance bank,
    TF32 off: metrics within 1e-4 relative, gradients held by
    :func:`_hold_grads`."""
    from hifigan_tpu_torch.train import s2st_task

    task = s2st_task.S2STTaskConfig(n_utterances=2, batch_size=2)
    bank = s2st_task.build_s2st_bank(task)
    states, metrics = {}, {}
    for dev in ("cuda", "cpu"):
        states[dev] = s2st_task.create_s2st_state(s2st_task.small_config(), task, torch.float32, dev, seed=1)
        step = s2st_task.make_s2st_train_step(task, {k: torch.from_numpy(v).to(dev) for k, v in bank.items()})
        metrics[dev] = step(states[dev], {k: torch.tensor(v) for k, v in RUNS_S2ST_DRAW.items()})[1]
    err = _loss_err(metrics["cuda"], metrics["cpu"], "S2ST")
    grads = _hold_grads([(states["cuda"].model, states["cpu"].model)], "S2ST")
    return {"loss_err": err, "grads": grads, "metrics": {k: float(v) for k, v in metrics["cuda"].items()}}


def _changed(module, start: dict) -> int:
    return sum(not torch.equal(p.detach(), start[n]) for n, p in module.named_parameters())


def _check_train_runs(directory: str, generator) -> dict:
    """The unit-vocoder and S2ST training paths on the card, through
    ``cli.main`` as a user runs them (TF32 turned on before each command,
    off after it).

    1. ``cli train-unit-vocoder`` at UnitVocoderTaskConfig() (fp32, the
       CLI's default) for RUNS_WARMUP + RUNS_TIMED steps from the seeded
       state, logging every step: finite losses, more than 90% of the
       parameter tensors changed, no GRC launch, ``code_config.json`` and
       the last ``<step>.pt`` written; then RUNS_BF16_STEPS steps with
       ``--bf16`` into another directory: finite losses.
    2. :func:`_check_uv_step_on_cpu`.
    3. ``cli train-s2st --eval_samples RUNS_EVAL_SAMPLES`` at
       small_config() for RUNS_WARMUP + RUNS_TIMED steps: finite losses,
       ``transition_acc`` in [0, 1], more than 90% of the parameter tensors
       changed, no GRC launch, ``s2st_eval.json`` with JAX's keys.
    4. :func:`_check_s2st_step_on_cpu`.
    5. ``cli eval-s2st --checkpoint_dir <3's run> --unit_vocoder <1's run>``
       over 2 held-out utterances and two text policies: JAX's report
       keys, the run's step, no GRC launch.
    6. ``cli info``: the total is ``generator``'s parameter count.
    The step times are CUDA events around each step as the commands run
    it."""
    import os

    from hifigan_tpu_torch.train import s2st_task as s2st_mod
    from hifigan_tpu_torch.train import unit_vocoder as uv_mod

    uv_dir, uv16_dir, s2_dir = (f"{directory}/{d}" for d in ("unit_vocoder", "unit_vocoder_bf16", "s2st"))
    n_steps = RUNS_WARMUP + RUNS_TIMED
    uv_task = uv_mod.UnitVocoderTaskConfig()
    seeded = uv_mod.create_unit_vocoder_state(TrainConfig(warmup_steps=1000), uv_task, torch.float32, "cuda", seed=0)
    uv_start = {m: {n: p.detach().clone() for n, p in getattr(seeded, m).named_parameters()}
                for m in ("vocoder", "discriminators")}
    del seeded
    uv_steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    with _timed_steps(uv_mod, "make_unit_vocoder_train_step", uv_steps):
        _cli(["train-unit-vocoder", "--device", "cuda", "--checkpoint_dir", uv_dir, "--dataset_size",
              str(RUNS_UV_DATASET), "--max_steps", str(n_steps), "--log_every", "1"])
    torch.cuda.synchronize()
    uv_wall = time.perf_counter() - t0
    uv_peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    uv_launches = dict(grc_kernel.launches)
    uv_rows = _metrics_rows(uv_dir)
    uv_state = uv_steps[-1]["state"]
    uv_changed = {m: _changed(getattr(uv_state, m), uv_start[m]) for m in uv_start}
    with open(f"{uv_dir}/code_config.json") as f:
        code_config = json.load(f)
    if (len(uv_rows) != n_steps or any(uv_launches.values())
            or not all(math.isfinite(v) for r in uv_rows for v in r.values())
            or not {"generator_loss", "discriminator_loss", "adv_loss", "fm_loss", "mel_loss", "dur_loss",
                    "stft_loss"} <= set(uv_rows[0])):
        raise AssertionError(f"cli train-unit-vocoder: rows {uv_rows}, GRC launches {uv_launches}")
    if any(n <= 0.9 * len(uv_start[m]) for m, n in uv_changed.items()):
        raise AssertionError(f"cli train-unit-vocoder changed only {uv_changed} tensors")
    if code_config != json.loads(json.dumps(dataclasses.asdict(uv_task.code))) or not os.path.exists(
            f"{uv_dir}/{n_steps}.pt"):
        raise AssertionError(f"cli train-unit-vocoder wrote {code_config} and {sorted(os.listdir(uv_dir))}")
    _reset_launches()
    _cli(["train-unit-vocoder", "--device", "cuda", "--bf16", "--checkpoint_dir", uv16_dir, "--dataset_size",
          str(RUNS_UV_DATASET), "--max_steps", str(RUNS_BF16_STEPS), "--log_every", "1"])
    uv16_rows = _metrics_rows(uv16_dir)
    if (len(uv16_rows) != RUNS_BF16_STEPS or any(grc_kernel.launches.values())
            or not all(math.isfinite(v) for r in uv16_rows for v in r.values())):
        raise AssertionError(f"cli train-unit-vocoder --bf16: rows {uv16_rows}, GRC launches {grc_kernel.launches}")
    uv_check = _check_uv_step_on_cpu()

    s2_steps = []
    seeded = s2st_mod.create_s2st_state(s2st_mod.small_config(), s2st_mod.S2STTaskConfig(), torch.float32, "cuda",
                                        seed=0)
    s2_start = {n: p.detach().clone() for n, p in seeded.model.named_parameters()}
    del seeded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    with _timed_steps(s2st_mod, "make_s2st_train_step", s2_steps), contextlib.redirect_stdout(io.StringIO()) as out:
        _cli(["train-s2st", "--device", "cuda", "--checkpoint_dir", s2_dir, "--dataset_size",
              str(RUNS_S2ST_DATASET), "--eval_samples", str(RUNS_EVAL_SAMPLES), "--max_steps", str(n_steps),
              "--log_every", "1"])
    torch.cuda.synchronize()
    s2_wall = time.perf_counter() - t0
    s2_peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    s2_launches = dict(grc_kernel.launches)
    s2_rows = _metrics_rows(s2_dir)
    s2_state = s2_steps[-1]["state"]
    s2_changed = _changed(s2_state.model, s2_start)
    with open(f"{s2_dir}/s2st_eval.json") as f:
        s2_eval = json.load(f)
    if (len(s2_rows) != n_steps or any(s2_launches.values())
            or not all(math.isfinite(v) for r in s2_rows for v in r.values())
            or not all(0.0 <= r["transition_acc"] <= 1.0 for r in s2_rows)):
        raise AssertionError(f"cli train-s2st: rows {s2_rows}, GRC launches {s2_launches}")
    if s2_changed <= 0.9 * len(s2_start):
        raise AssertionError(f"cli train-s2st changed only {s2_changed} of {len(s2_start)} tensors")
    if (set(s2_eval) != S2ST_EVAL_KEYS or s2_eval["n"] != RUNS_EVAL_SAMPLES or s2_eval["step"] != n_steps
            or json.loads(out.getvalue().strip().splitlines()[-1]) != s2_eval):
        raise AssertionError(f"cli train-s2st's s2st_eval.json: {s2_eval}")
    s2_check = _check_s2st_step_on_cpu()

    report_path = f"{directory}/eval_s2st.json"
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _cli(["eval-s2st", "--device", "cuda", "--checkpoint_dir", s2_dir, "--unit_vocoder", uv_dir, "--samples",
              "2", "--policies", "offline_greedy,stride1_greedy", "--speech_policies", "stride1", "--output",
              report_path])
    es_wall = time.perf_counter() - t0
    with open(report_path) as f:
        es_report = json.load(f)
    if (set(es_report) != EVAL_S2ST_REPORT_KEYS or es_report["restored_step"] != n_steps
            or es_report["checkpoint_dir"] != s2_dir or any(grc_kernel.launches.values())
            or set(es_report["policies"]) != {"offline_greedy", "stride1_greedy"}):
        raise AssertionError(f"cli eval-s2st over the run directories: {es_report}, GRC launches "
                             f"{grc_kernel.launches}")

    with contextlib.redirect_stdout(io.StringIO()) as out:
        _cli(["info"])
    info = json.loads(out.getvalue())
    n_gen = sum(p.numel() for p in generator.parameters())
    if set(info) != {"total_parameters", "parameter_mb", "per_module_parameters"} or info["total_parameters"] != n_gen:
        raise AssertionError(f"cli info printed {info}; the generator has {n_gen} parameters")
    return {"uv_rows": uv_rows, "uv16_rows": uv16_rows, "uv_ms": [r["ms"] for r in uv_steps], "uv_wall": uv_wall,
            "uv_peak_mib": uv_peak_mib, "uv_changed": uv_changed, "uv_check": uv_check,
            "uv_trace": uv_steps[-1], "s2_rows": s2_rows, "s2_ms": [r["ms"] for r in s2_steps], "s2_wall": s2_wall,
            "s2_peak_mib": s2_peak_mib, "s2_changed": s2_changed, "s2_tensors": len(s2_start), "s2_eval": s2_eval,
            "s2_check": s2_check, "s2_trace": s2_steps[-1], "es_report": es_report, "es_wall": es_wall,
            "info": info}


def _report_train_runs(runs: dict, card: str) -> None:
    """Print phase 12's ``train_runs:`` and ``timing_train_runs:`` lines."""
    uv_ms = statistics.median(runs["uv_ms"][RUNS_WARMUP:])
    s2_ms = statistics.median(runs["s2_ms"][RUNS_WARMUP:])
    uv_task_cfg = UnitVocoderTaskConfig()
    s2_task_cfg = S2STTaskConfig()
    last = lambda rows: {k: float(f"{v:.4g}") for k, v in rows[-1].items() if k not in ("step", "wall_s")}  # noqa: E731
    fmt = lambda d: json.dumps({k: (float(f"{v:.3g}") if isinstance(v, float) else v) for k, v in d.items()})  # noqa: E731
    print(f"train_runs: cli train-unit-vocoder UnitVocoderTaskConfig() fp32 ({uv_task_cfg.batch_size} x "
          f"{uv_task_cfg.window_units} units = {uv_task_cfg.window_samples} samples a step, {RUNS_UV_DATASET} "
          f"utterances), {RUNS_WARMUP + RUNS_TIMED} steps: losses finite, last row {json.dumps(last(runs['uv_rows']))}, "
          f"parameter tensors changed {runs['uv_changed']}, 0 GRC launches, code_config.json and "
          f"{RUNS_WARMUP + RUNS_TIMED}.pt written; --bf16 {RUNS_BF16_STEPS} steps finite "
          + json.dumps([round(r["generator_loss"], 4) for r in runs["uv16_rows"]])
          + f"; fp32 unit-vocoder step card vs CPU at 1 x {runs['uv_check']['samples']} samples (the CLI's loss "
          f"weights, STFT included): max loss rel err {runs['uv_check']['loss_err']:.3g} (tol 1e-4), gradients (tol "
          f"{PIPE_GRAD_FRAC} of each leaf's peak, {PIPE_GRAD_L2} in L2) " + fmt(runs["uv_check"]["grads"])
          + f"; cli train-s2st small_config() fp32 ({s2_task_cfg.batch_size} x {s2_task_cfg.n_frames} frames, "
          f"{RUNS_S2ST_DATASET} utterances), {RUNS_WARMUP + RUNS_TIMED} steps: last row "
          f"{json.dumps(last(runs['s2_rows']))}, parameter tensors changed {runs['s2_changed']} of "
          f"{runs['s2_tensors']}, 0 GRC launches, s2st_eval.json {json.dumps(runs['s2_eval'])}; fp32 S2ST step card "
          f"vs CPU at batch 2: max loss rel err {runs['s2_check']['loss_err']:.3g} (tol 1e-4), gradients "
          + fmt(runs["s2_check"]["grads"])
          + f"; cli eval-s2st --checkpoint_dir --unit_vocoder over 2 utterances: keys JAX's, restored step "
          f"{runs['es_report']['restored_step']}, 0 GRC launches, policies {json.dumps(runs['es_report']['policies'])}; "
          f"cli info total_parameters {runs['info']['total_parameters']} ({runs['info']['parameter_mb']} MB) = the "
          f"generator's")
    uv_audio_s = uv_task_cfg.batch_size * uv_task_cfg.window_samples / 16000
    s2_audio_s = s2_task_cfg.batch_size * s2_task_cfg.max_seconds
    print(f"timing_train_runs: {card}; train-unit-vocoder step (fp32) median "
          f"{uv_ms:.3f} ms over {RUNS_TIMED} after {RUNS_WARMUP} ({json.dumps([round(t, 3) for t in runs['uv_ms']])} "
          f"ms), {uv_audio_s / uv_ms * 1e3:.1f} audio-s trained a second, peak device memory "
          f"{runs['uv_peak_mib']:.1f} MiB above what was held before it, command {runs['uv_wall']:.2f} s wall; "
          f"train-s2st step (fp32) median {s2_ms:.3f} ms ({json.dumps([round(t, 3) for t in runs['s2_ms']])} ms), "
          f"{s2_audio_s / s2_ms * 1e3:.1f} source audio-s trained a second, peak device memory "
          f"{runs['s2_peak_mib']:.1f} MiB, command {runs['s2_wall']:.2f} s wall (held-out eval included); "
          f"cli eval-s2st over the run directories {runs['es_wall']:.2f} s wall")


def _check_parallel(directory: str) -> dict:
    """Phase 15: the port's parallelism on one card.

    - NCCL at world 1 (NCCL places one rank on a card), its group destroyed
      at the end: ``make_sharded_train_step`` over ``make_mesh(1, 1)`` at
      TrainConfig() bf16, 16 x 8192 samples a step from phase 7's
      ``make_device_sampler``, PARALLEL_WARMUP + PARALLEL_STEPS steps beside
      the plain step from the same seeds, cuDNN deterministic: the losses
      equal bit for bit, two gradient all-reduces a step (one an optimiser
      update), no GRC-kernel launch (the step differentiates the plain
      chain, as the plain step does); then both timed by CUDA events, PARALLEL_TIMED steps each
      after PARALLEL_WARMUP, alternating, cuDNN's default algorithms.
    - ``conformer_forward_seq_sharded`` over the StreamSpeechConfig()
      encoder (d 512, 12 layers, 8 heads, chunk 32), fp32, TF32 off, on
      1 x SP_FRAMES frames against ``ChunkedConformer(chunked=True)``:
      within 1e-4 of the output's peak; both wall times (CUDA events).
    - ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
      hifigan_tpu_torch.cli train --bf16 --dataset formant --device_data
      --max_steps 2`` exits 0, and its metrics.jsonl equals the same
      command's without the launcher (within 1e-4 relative: cuDNN's default
      backward algorithms may add in another order run to run).
    - ``dryrun_multichip(1)`` on the card (a spawned NCCL rank), then
      ``dryrun_multichip(4, device="cpu")``: four gloo processes on the
      card machine's CPU, a check of its PyTorch distributed API, not a
      timing."""
    from hifigan_tpu_torch.entry import dryrun_multichip
    from hifigan_tpu_torch.models.conformer import ChunkedConformer
    from hifigan_tpu_torch.parallel import (
        conformer_forward_seq_sharded,
        make_mesh,
        make_sharded_train_step,
        single_process_group,
    )
    from hifigan_tpu_torch.parallel.tensor import counts

    cfg = TrainConfig()
    out = {}
    with single_process_group("cuda"):
        mesh = make_mesh(1, 1)
        bank, lengths = build_audio_bank(SyntheticSpeechDataset(segment_samples=TRAIN_SEGMENT, size=TRAIN_BANK_ROWS))
        sample = make_device_sampler(torch.from_numpy(bank).cuda(), torch.from_numpy(lengths), TRAIN_SEGMENT,
                                     TRAIN_BATCH)
        plain_state, mesh_state = (create_train_state(cfg, torch.bfloat16, "cuda", seed=0) for _ in range(2))
        plain = make_train_step(cfg, sample_fn=sample)
        sharded = make_sharded_train_step(make_train_step(cfg, sample_fn=sample), mesh)
        n = PARALLEL_WARMUP + PARALLEL_STEPS
        losses = {"plain": [], "mesh": []}
        reduces = []
        _reset_launches()
        torch.backends.cudnn.deterministic = True
        try:
            for i in range(n):
                losses["plain"].append({k: float(v) for k, v in plain(plain_state, 100 + i)[1].items()})
                before = counts["grad_all_reduce"]
                losses["mesh"].append({k: float(v) for k, v in sharded(mesh_state, 100 + i)[1].items()})
                reduces.append(counts["grad_all_reduce"] - before)
        finally:
            torch.backends.cudnn.deterministic = False
        if losses["plain"] != losses["mesh"]:
            raise AssertionError(f"the sharded step's losses differ from the plain step's: {losses}")
        if reduces != [2] * n:
            raise AssertionError(f"gradient all-reduces a step {reduces}, expected 2 (one an optimiser update)")
        grc_launches = dict(grc_kernel.launches)
        if any(grc_launches.values()):
            raise AssertionError(f"the sharded and plain train steps launched the GRC kernels {grc_launches}")
        times = {"plain": [], "mesh": []}
        for i in range(PARALLEL_WARMUP + PARALLEL_TIMED):
            for key, fn, st in (("plain", plain, plain_state), ("mesh", sharded, mesh_state)):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn(st, 200 + i)
                end.record()
                end.synchronize()
                times[key].append(start.elapsed_time(end))
        out.update(losses=losses["mesh"], reduces=reduces[0], times=times, grc_launches=grc_launches,
                   step_ms={k: statistics.median(v[PARALLEL_WARMUP:]) for k, v in times.items()})
        del plain_state, mesh_state, bank

        s2 = StreamSpeechConfig()
        enc = ChunkedConformer(s2.input_dim, s2.hidden_dim, s2.encoder_layers, s2.num_heads, s2.chunk_size,
                               gen=torch.Generator().manual_seed(0)).cuda().eval()
        mel = torch.randn((1, SP_FRAMES, s2.input_dim), generator=torch.Generator().manual_seed(1)).cuda()
        with torch.no_grad():
            want = enc(mel, chunked=True)
            got = conformer_forward_seq_sharded(enc, mel)
        sp_err = float((got - want).abs().max() / want.abs().max())
        if tuple(got.shape) != (1, SP_FRAMES, s2.hidden_dim) or not sp_err <= 1e-4:
            raise AssertionError(f"sequence-parallel encoder {tuple(got.shape)} off by {sp_err:.3g} of the peak")
        with torch.no_grad():
            out["sp_ms"] = _time_ms(lambda: conformer_forward_seq_sharded(enc, mel), runs=5)
            out["plain_encoder_ms"] = _time_ms(lambda: enc(mel, chunked=True), runs=5)
        out.update(sp_err=sp_err, encoder_params=sum(p.numel() for p in enc.parameters()))
        del enc, mel, want, got
    if torch.distributed.is_initialized():
        raise AssertionError("the NCCL group of the parallel phase was not destroyed")

    argv = ["train", "--bf16", "--dataset", "formant", "--dataset_size", str(PARALLEL_CORPUS), "--device_data",
            "--max_steps", "2", "--log_every", "1"]
    walls, rows = {}, {}
    for key, launcher in (("launched", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                        "--nproc_per_node", "1"]), ("plain", [sys.executable])):
        run_dir = os.path.join(directory, key)
        t0 = time.perf_counter()
        proc = subprocess.run(launcher + ["-m", "hifigan_tpu_torch.cli"] + argv + ["--checkpoint_dir", run_dir],
                              capture_output=True, text=True, timeout=600)
        walls[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli train ({key}) exited {proc.returncode}: {proc.stderr[-3000:]}")
        rows[key] = _metrics_rows(run_dir)
        for row in rows[key]:
            row.pop("wall_s")
    if [r["step"] for r in rows["launched"]] != [1, 2] or len(rows["plain"]) != 2:
        raise AssertionError(f"cli train metrics rows: {rows}")
    cli_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(rows["launched"], rows["plain"])
                  for k in b)
    if cli_err > 1e-4 or rows["launched"][0].keys() != rows["plain"][0].keys():
        raise AssertionError(f"cli train under the launcher differs from the plain run: {rows}")
    out.update(cli_walls=walls, cli_err=cli_err, cli_rows=rows["launched"])

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        card = dryrun_multichip(1)
        out["dryrun_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gloo = dryrun_multichip(4, device="cpu")
        out["dryrun_gloo_s"] = time.perf_counter() - t0
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("dryrun_multichip OK")]
    if len(lines) != 2 or gloo["mesh"] != {"data": 2, "model": 2} or gloo["tp_all_reduces"] != 10:
        raise AssertionError(f"dryrun_multichip: {buf.getvalue()[-2000:]}")
    out.update(dryrun_lines=lines, dryrun_card=card, dryrun_gloo=gloo)
    return out


# The bench phase: `cli bench`'s configs, the GRC kernels each must launch per
# timed or warm-up call (bf16 forwards: the 9 MRF steps), and the JAX
# command's stdout keys.
BENCH_GRC_STEPS = {"flagship_odconv_grc_film": 9, "hifigan_v1": 0, "conditioned_auto_embeddings": 9,
                   "gan_train_step": 0, "gan_train_step_production": 0}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _check_bench() -> dict:
    """Phase 16: ``cli bench`` through ``cli.main`` (``_cli``), its stdout
    and stderr captured.  Its stdout is one line with the JAX command's four
    keys, metric and unit, a finite value above 0 and ``vs_baseline =
    round(value / 50, 2)``; its stderr's record holds the five configs, none
    with an error, the card and ``vs_prev_round: null``.  Each config's
    function is wrapped to set the GRC launch counts to 0 before it and read
    them after it: the flagship and conditioned configs launch ``grc_step_bf16`` 9 times a
    call (``INFER_CALLS + WARMUP`` calls), no config launches
    ``grc_step_f32``, and HiFi-GAN V1 and the train steps launch none."""
    from hifigan_tpu_torch import bench

    per_config = {}

    def counted(name, fn):
        def run(device):
            _reset_launches()
            result = fn(device=device)
            per_config[name] = dict(grc_kernel.launches)
            return result
        return run

    configs = bench.CONFIGS
    bench.CONFIGS = [(name, counted(name, fn)) for name, fn in configs]
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            _cli(["bench"])
    finally:
        bench.CONFIGS = configs
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"cli bench printed {len(lines)} stdout lines: {out.getvalue()[-2000:]}")
    line = json.loads(lines[0])
    value = line.get("value")
    if (set(line) != BENCH_KEYS or line["metric"] != bench.METRIC or line["unit"] != "x_realtime"
            or not isinstance(value, float) or not math.isfinite(value) or value <= 0
            or line["vs_baseline"] != round(value / 50, 2)):
        raise AssertionError(f"cli bench's stdout line: {lines[0]}")
    records = [json.loads(r) for r in err.getvalue().splitlines() if r.startswith('{"configs"')]
    if len(records) != 1:
        raise AssertionError(f"cli bench's stderr: {err.getvalue()[-2000:]}")
    record = records[0]
    if (list(record["configs"]) != list(BENCH_GRC_STEPS) or record["vs_prev_round"] is not None
            or any("error" in r for r in record["configs"].values())):
        raise AssertionError(f"cli bench's stderr record: {json.dumps(record)[:2000]}")
    calls = bench.INFER_CALLS + bench.WARMUP
    want = {name: {"grc_step_bf16": steps * calls, "grc_step_f32": 0} for name, steps in BENCH_GRC_STEPS.items()}
    if per_config != want:
        raise AssertionError(f"cli bench's GRC launches {per_config}, want {want}")
    # each kernel's launches a forward of the configs that run the GRC steps
    # (the same in each, as checked just above)
    per_forward = {kernel: per_config[name][kernel] // calls
                   for name, steps in BENCH_GRC_STEPS.items() if steps for kernel in grc_kernel.launches}
    return {"line": line, "record": record, "launches": per_config, "per_forward": per_forward, "wall_s": wall}


# The serving phase: the app's stdlib server (what `cli serve` runs without
# FastAPI) over an engine whose TTS routes mels through make_vocoder_synth of
# a seeded create_train_state(TrainConfig()) checkpoint, bf16 (the default).
# The machine has no HF weights (none are fetched), so the ASR and MT stages degrade (empty
# transcript, identity translation) and SpeechT5's text -> mel stage is given
# a seeded [SERVE_FRAMES, 80] mel: 1 x 256 frames = 65,536 samples a call.
SERVE_FRAMES, SERVE_REQUESTS = 256, 5
SERVE_PCM_STEP = 1 / 32768  # one 16-bit PCM step as wav_bytes_to_float decodes it


def _http(base: str, path: str, payload=None) -> dict:
    """GET ``path`` (``payload`` None) or POST it as JSON; the JSON reply."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _check_serving(directory: str) -> dict:
    """Phase 14: a seeded ``create_train_state(TrainConfig())`` written by
    ``CheckpointManager`` into ``directory`` (the JAX initialisers' draw:
    with zero speaker and emotion, phase 4's redraw gives a waveform of a
    few PCM steps, too quiet for the WAV check), the app's
    ``StdlibServer`` on port 0 in the background over an engine built with
    ``vocoder_checkpoint`` set to it, then over HTTP: health, models info
    (the framework vocoder in use), a text translation (the identity
    fallback) and a synthesis, whose WAV must decode to the direct
    ``make_vocoder_synth(mel)`` output's WAV within one PCM step; one synth
    call (and one synthesis request) launches ``grc_step_bf16`` 9 times and
    nothing else of the GRC family; the kernel path matches the same call
    through ``grc_step_reference`` within phase 4's bf16 tolerance; each of
    the synth's 9 kernel steps, on the inputs the path gives it at
    ``[1, SERVE_FRAMES * 256, 32]`` bf16, and phase 3's seeded steps at that
    shape pass phase 3's check against the plain step, and that check
    refuses the plain step with the MRF taps zeroed on every one of those
    inputs (at this draw dropping the taps moves the waveform by only about
    the path's tolerance, but most elements of each step's output beyond
    phase 3's limit).  The
    server is stopped before this returns; the timed synth and the request
    are returned for phase 13's trace and the report."""
    state = create_train_state(TrainConfig(), torch.float32, "cuda", seed=5)
    state.step = 1
    CheckpointManager(directory).save(state, force=True)
    del state
    base_cfg = Settings()
    cfg = replace(base_cfg, web=replace(base_cfg.web, port=0),
                  models=replace(base_cfg.models, vocoder_checkpoint=directory))
    t0 = time.perf_counter()
    srv = StdlibServer(cfg=cfg, offline=OfflineManager(os.path.join(directory, "offline")), device="cuda")
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    make_vocoder_synth(directory, device="cuda")  # the engine's vocoder alone, built again
    vocoder_s = time.perf_counter() - t0
    mel = np.random.default_rng(7).standard_normal((SERVE_FRAMES, 80)).astype(np.float32)
    texts = []
    srv.engine.tts.text_to_mel = lambda text: texts.append(text) or mel
    synth = srv.engine.tts.vocoder_synth
    base = f"http://127.0.0.1:{srv.start(background=True)}"
    try:
        health = _http(base, "/api/health")
        info = _http(base, "/api/models/info")
        translated = _http(base, "/api/translate/text", {"text": "good morning"})
        _reset_launches()
        reply = _http(base, "/api/synthesize/text", {"text": "hola mundo"})
        request_launches = dict(grc_kernel.launches)
        walls = []
        for _ in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            _http(base, "/api/synthesize/text", {"text": "hola mundo"})
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        srv.stop()
    if health.get("status") != "ok":
        raise AssertionError(f"/api/health answered {health}")
    if info["engine"]["tts"]["uses_framework_vocoder"] is not True:
        raise AssertionError(f"/api/models/info: the TTS does not use the framework vocoder: {info['engine']['tts']}")
    if translated["translated_text"] != "good morning":
        raise AssertionError(f"/api/translate/text answered {translated} (expected the identity fallback)")
    if texts[0] != "hola mundo":
        raise AssertionError(f"the TTS stage saw {texts[:1]}")
    mel_in = mel.T[None]
    _reset_launches()
    direct = synth(mel_in)
    launches = dict(grc_kernel.launches)
    plain = synth(mel_in, step=grc_kernel.grc_step_reference)
    path_steps = []

    def recording(*args, lo, dilation):
        out = grc_kernel.grc_step(*args, lo=lo, dilation=dilation)
        path_steps.append((args, lo, dilation, out))
        return out

    synth(mel_in, step=recording)
    expect = {"grc_step_f32": 0, "grc_step_bf16": 9}
    for what, got in (("a synth call", launches), ("a synthesis request", request_launches)):
        if got != expect:
            raise AssertionError(f"{what} launched the GRC kernels {got}, expected {expect}")
    served, sr = wav_bytes_to_float(base64.b64decode(reply["audio"]))
    want, _ = wav_bytes_to_float(float_to_wav_bytes(direct))
    if sr != 16000 or served.shape != (SERVE_FRAMES * 256,) or direct.shape != served.shape:
        raise AssertionError(f"served WAV {served.shape} at {sr} Hz, direct {direct.shape}")
    pcm_err = float(np.abs(served - want).max())
    if pcm_err > SERVE_PCM_STEP:
        raise AssertionError(f"the served WAV differs from the direct synth's by {pcm_err:.3g} > one PCM step")
    if not np.isfinite(direct).all() or direct.std() < 32 * SERVE_PCM_STEP:
        raise AssertionError(f"the synth output is not finite or is flat (std {direct.std():.3g})")
    kernel_err = float(np.abs(direct - plain).max())
    kernel_tol = 4 * 2.0 ** -8 * float(np.abs(plain).max())
    if kernel_err > kernel_tol:
        raise AssertionError(f"the synth's kernel path differs from its plain path by {kernel_err:.3g} > "
                             f"{kernel_tol:.3g}")
    shape = (1, SERVE_FRAMES * 256, C)
    if len(path_steps) != 9 or any(tuple(a[0].shape) != shape or a[0].dtype != torch.bfloat16
                                   for a, *_ in path_steps):
        raise AssertionError(f"the synth ran {len(path_steps)} GRC steps, expected 9 on {shape} bf16")
    cfg = GeneratorConfig()
    seeded = [(k, d) for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations) for d in dils]
    step_worst = {"path": (0.0, 0.0), "seeded": (0.0, 0.0)}
    with torch.no_grad():
        checks = [("path", args, lo, dilation, out) for args, lo, dilation, out in path_steps]
        for i, (k, d) in enumerate(seeded):
            for normalised in (False, True):
                args, lo = _step_inputs(k, d, torch.bfloat16, normalised, seed=100 * i + normalised, batch=1,
                                        length=SERVE_FRAMES * 256)
                checks.append(("seeded", args, lo, d, grc_kernel.grc_step(*args, lo=lo, dilation=d)))
        for what, args, lo, dilation, out in checks:
            want = grc_kernel.grc_step_reference(*args, lo=lo, dilation=dilation)
            torch.cuda.synchronize()
            e, r = _check_step(out, want, torch.bfloat16)
            _check_sees_taps(args, lo, dilation, want, torch.bfloat16)
            step_worst[what] = (max(step_worst[what][0], e), max(step_worst[what][1], r))
    with torch.no_grad():
        synth_ms = _time_ms(lambda: synth(mel_in))
    return {"synth": synth, "mel": mel_in, "launches": launches, "request_launches": request_launches,
            "pcm_err": pcm_err, "kernel_err": kernel_err, "kernel_tol": kernel_tol, "step_worst": step_worst,
            "steps_checked": len(checks),
            "synth_ms": synth_ms,
            "request_ms": statistics.median(walls), "request_walls_ms": walls, "engine_s": engine_s,
            "vocoder_s": vocoder_s,
            "peak": float(np.abs(direct).max()), "std": float(direct.std())}


def _hmt_stacks() -> tuple[S2STInference, S2STInference]:
    """The seeded S2ST3_CONFIG stack and UNIT_VOCODER_CONFIG unit vocoder,
    fp32, on the card and (the same weights) on the CPU."""
    model = StreamSpeechS2ST(StreamSpeechConfig(**S2ST3_CONFIG), gen=torch.Generator().manual_seed(13),
                             with_vocoder=False).eval()
    code = CodeVocoder(CodeVocoderConfig(**UNIT_VOCODER_CONFIG), gen=torch.Generator().manual_seed(14)).eval()
    cfg = S2STInferenceConfig(max_target_len=HMT_MAX_TARGET_LEN)
    cpu = S2STInference(copy.deepcopy(model), copy.deepcopy(code), cfg)
    return S2STInference(model.cuda(), code.cuda(), cfg), cpu


def _check_hmt_programs(card: S2STInference, cpu: S2STInference) -> dict:
    """The beam and HMT programs on the card against the CPU, on the CPU's
    encoder output over 40 frames (a 64-frame bucket), TF32 off, within 1e-4
    of each output's peak: ``_hmt_prefill`` of 4 rows of 64 tokens under 4
    read lengths (the cache), one KV step at 16 rows gathered by parent
    under 16 distinct read lengths for each gate (log-probs; the learned
    one's write probabilities), ``_decode_scores_hmt`` over 16 rows, and
    ``_prefill_lp`` then one ``_beam_step`` at 5 reordered rows.  Returns
    each check's (max err, tolerance) and the card's inputs for timing."""
    g = torch.Generator().manual_seed(23)
    cfg, L = card.model.config, HMT_MAX_TARGET_LEN
    mel = torch.randn((40, cfg.input_dim), generator=g).numpy()
    enc = cpu.encode_prefix(mel)["enc"]
    S, rows = enc.shape[1], HMT_BEAM * HMT_CANDS
    tokens = torch.randint(3, cfg.vocab_size, (HMT_BEAM, L), generator=g)
    tokens[:, 0] = card.cfg.bos_id
    reads0 = torch.tensor([1, 17, 33, 40])
    parents = torch.arange(rows) // HMT_CANDS
    last = torch.randint(3, cfg.vocab_size, (rows,), generator=g)
    reads = torch.randperm(S, generator=g)[:rows] + 1
    rows_tokens = torch.randint(3, cfg.vocab_size, (rows, L), generator=g)
    rows_tokens[:, 0] = card.cfg.bos_id
    buf = torch.zeros((HMT_BEAM_STEP_ROWS, L), dtype=torch.int64)
    buf[:, :8] = tokens[0, :8]
    beam_parents, beam_tokens = torch.tensor([3, 1, 1, 0, 4]), torch.randint(3, cfg.vocab_size, (5,), generator=g)
    out, inputs = {}, {}
    with torch.no_grad():
        for side, inf in (("card", card), ("cpu", cpu)):
            dev = inf.device
            ckv = inc.cross_kv(inf.model.text_decoder, enc.to(dev))
            cache = inf._hmt_prefill(ckv, tokens.to(dev), inc.init_cache(inf.decoder_spec, HMT_BEAM, L, dev),
                                     reads0.to(dev))
            cache = inc.with_index(cache, 20)
            o = {"_hmt_prefill cache k": cache.k, "_hmt_prefill cache v": cache.v}
            step_args = (last.to(dev), parents.to(dev), reads.to(dev))
            for learned in (False, True):
                lp, wp, _ = inf._hmt_kv_step(ckv, cache, *step_args, learned=learned)
                o[f"KV step ({'learned' if learned else 'confidence'}) log-probs"] = lp
                if learned:
                    o["KV step (learned) write probabilities"] = wp
            lp, wp = inf._decode_scores_hmt(enc.to(dev), rows_tokens.to(dev), reads.to(dev))
            o["_decode_scores_hmt log-probs"], o["_decode_scores_hmt write probabilities"] = lp, wp
            lp, beam_cache = inf._prefill_lp(ckv, buf.to(dev), inc.init_cache(inf.decoder_spec, 5, L, dev))
            beam_cache = inc.with_index(beam_cache, 8)
            o["_prefill_lp log-probs"] = lp
            o["_beam_step log-probs"] = inf._beam_step(ckv, beam_cache, beam_tokens.to(dev), beam_parents.to(dev))[0]
            out[side] = o
            if side == "card":
                inputs = {"ckv": ckv, "cache": cache, "step_args": step_args, "beam_cache": beam_cache,
                          "beam_args": (beam_tokens.to(dev), beam_parents.to(dev))}
    checks = {name: _peak_err(out["card"][name], out["cpu"][name]) for name in out["cpu"]}
    for name, (err, tol) in checks.items():
        if not err <= tol:
            raise AssertionError(f"HMT {name}: card vs CPU max err {err:.3g} > {tol:.3g}")
    return {"checks": checks, "inputs": inputs}


def _hmt_margin(lp: np.ndarray, wp) -> float:
    """The closest decision a KV HMT step's scores feed: the gate (the
    write probability, or the top token's probability with and without
    EOS, against the threshold) and, per row, the gaps between the top
    beam + 2 log-probs (the argpartition boundary and the candidates'
    order)."""
    lp = np.asarray(lp, np.float64)
    gates = [wp] if wp is not None else [np.exp(lp.max(-1)), np.exp(np.delete(lp, 2, axis=-1).max(-1))]
    m = min(float(np.abs(np.asarray(p, np.float64) - HMT_WRITE_THRESHOLD).min()) for p in gates)
    top = -np.sort(-lp, axis=-1)[:, : HMT_BEAM + 2]
    return min(m, float(np.abs(np.diff(top, axis=-1)).min()))


def _hmt_state_key(st) -> tuple:
    return (st.need_read, [(h.tokens, h.num_read, h.reads, h.finished, h.row) for h in st.beams],
            [(h.tokens, h.num_read, h.reads, h.finished, h.row) for h in st.finished])


def _check_hmt_continuations(card: S2STInference, cpu: S2STInference) -> dict:
    """For each gate, one ``continue_text_hmt`` call over 40 frames of a
    noise mel (the source open) and the same state resumed over all 72
    (the source finished), on the card and on the CPU, each side encoding
    its own prefix.  The states (beams, reads, read pointers, rows,
    ``need_read``) must be equal after each call where the margins allow:
    where they are not, the runs must part after a KV step whose closest
    decision lies within 10x the float error measured between the two
    sides' KV steps before it (counted as a near tie)."""
    mel = torch.randn((72, card.model.config.input_dim), generator=torch.Generator().manual_seed(24)).numpy()
    tapes = {"cuda": [], "cpu": []}
    step = s2st_runtime._HmtKvStepper.step

    def taped(stepper, last, parents, read_lens):
        lp, wp = step(stepper, last, parents, read_lens)
        tapes["cuda" if stepper.inf is card else "cpu"].append((np.array(last), np.array(parents),
                                                                 np.array(read_lens), lp, wp))
        return lp, wp

    s2st_runtime._HmtKvStepper.step = taped
    result = {"compared": 0, "equal": 0, "near_ties": [], "float_err": 0.0, "tokens": {}}
    try:
        for transition in ("confidence", "learned"):
            states = {"cuda": None, "cpu": None}
            tapes["cuda"].clear()
            tapes["cpu"].clear()
            for n, finished in ((40, False), (72, True)):
                for side, inf in (("cuda", card), ("cpu", cpu)):
                    enc = inf.encode_prefix(mel[:n])
                    states[side] = inf.continue_text_hmt(enc["enc"], [], src_len=enc["valid_frames"],
                                                         source_finished=finished, state=states[side],
                                                         transition=transition)
                result["compared"] += 1
                err, parted = 0.0, None
                for i, (a, b) in enumerate(zip(tapes["cpu"], tapes["cuda"])):
                    if any(not np.array_equal(x, y) for x, y in zip(a[:3], b[:3])):
                        parted = i
                        break
                    err = max(err, float(np.abs(a[3][np.isfinite(a[3])] - b[3][np.isfinite(b[3])]).max()),
                              0.0 if a[4] is None else float(np.abs(a[4] - b[4]).max()))
                result["float_err"] = max(result["float_err"], err)
                if _hmt_state_key(states["cuda"]) == _hmt_state_key(states["cpu"]):
                    result["equal"] += 1
                    continue
                if not parted:
                    raise AssertionError(f"continue_text_hmt ({transition}) differs on the card and the CPU although "
                                         "every KV step's inputs were equal")
                margin = _hmt_margin(*tapes["cpu"][parted - 1][3:])
                if margin > 10 * err:
                    raise AssertionError(f"continue_text_hmt ({transition}): the card and the CPU part after KV step "
                                         f"{parted - 1}, whose closest decision is {margin:.3g} > 10 x {err:.3g}")
                result["near_ties"].append({"transition": transition, "step": parted - 1, "margin": margin,
                                            "float_err": err})
                break
            result["tokens"][transition] = states["cuda"].best().tokens
    finally:
        s2st_runtime._HmtKvStepper.step = step
    return result


def _check_eval_s2st(card: S2STInference, directory: str) -> dict:
    """``cli eval-s2st`` on the card, through ``cli.main`` as a user runs
    it, over HMT_SAMPLES held-out formant utterances and HMT_POLICIES, with
    the seeded stack written by ``save_s2st_checkpoint`` and phase 9's
    seeded CTC judge: JAX's report keys, every policy's F1 and AL finite,
    the judge failing its gate and the speech rows skipped (as JAX's report
    reads for an untrained judge), no GRC-kernel launch (counted from 0
    just before the command), its wall time and peak device memory."""
    paths = {"s2st": f"{directory}/s2st.pt", "judge": f"{directory}/judge.pt", "out": f"{directory}/eval_s2st.json"}
    save_s2st_checkpoint(paths["s2st"], card.model, card.code_vocoder, step=0)
    save_ctc_judge(paths["judge"], StreamSpeechS2ST(StreamSpeechConfig(**JUDGE_CONFIG),
                                                    gen=torch.Generator().manual_seed(10), with_vocoder=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its report line; the report is the file
        _cli(["eval-s2st", "--device", "cuda", "--checkpoint", paths["s2st"], "--asr", paths["judge"],
                  "--samples", str(HMT_SAMPLES), "--policies", ",".join(HMT_POLICIES), "--output", paths["out"]])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    launches = dict(grc_kernel.launches)
    if any(launches.values()):
        raise AssertionError(f"cli eval-s2st launched the GRC kernels {launches}: its path runs none")
    with open(paths["out"]) as f:
        report = json.load(f)
    if set(report) != EVAL_S2ST_REPORT_KEYS or list(report["policies"]) != list(HMT_POLICIES):
        raise AssertionError(f"the eval-s2st report's keys {sorted(report)} / {list(report['policies'])} are not "
                             f"JAX's {sorted(EVAL_S2ST_REPORT_KEYS)} / {list(HMT_POLICIES)}")
    for name, row in report["policies"].items():
        if (set(row) != {"token_f1", "average_lagging_ms", "n"} or row["n"] != HMT_SAMPLES
                or not all(math.isfinite(row[k]) for k in ("token_f1", "average_lagging_ms"))):
            raise AssertionError(f"eval-s2st policy {name}: {row}")
    gate = report["asr_judge"]["gate"]
    if gate["selected"] is not None or report["asr_judge"]["dir"] is not None or report["restored_step"] != 0:
        raise AssertionError(f"the seeded judge passed its gate, or the step is wrong: {report['asr_judge']}, "
                             f"restored_step {report['restored_step']} (file: {read_s2st_step(paths['s2st'])})")
    return {"report": report, "wall_s": wall_s, "peak_mib": peak_mib, "launches": launches,
            "cer": gate["candidates"][0].get("ground_truth_cer")}


def _time_hmt(card: S2STInference, audio, inputs: dict) -> dict:
    """Wall times, before any trace: one ``S2TTAgent(decode="hmt")`` session
    of each gate over the S2ST phase's 5 s of source (host clock ending in a
    synchronise; its real-time factor, tokens and writes before the source
    ended), and the median of the KV HMT step (16 rows, the learned gate)
    and of the beam step (5 rows) by CUDA events around one eager call
    (``_time_ms``: the host's launches set the pace)."""
    source_s = S2ST_AUDIO_SAMPLES / S2ST_SAMPLE_RATE
    sessions = {}
    for transition in ("confidence", "learned"):
        agent = S2TTAgent(card, decode="hmt", hmt_transition=transition)
        calls, policy = [0], agent.policy

        def counted(states):
            calls[0] += 1
            return policy(states)

        agent.policy = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_streaming_session(agent, audio, sample_rate=S2ST_SAMPLE_RATE, segment_size_ms=S2ST_SEGMENT_MS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        sessions[transition] = {"wall_s": wall_s, "rtf": wall_s / source_s, "tokens": len(agent.committed_text_ids),
                                "policy_calls": calls[0],
                                "writes_before_end": sum(t < result.source_seconds
                                                         for t in result.emission_source_seconds)}
    with torch.no_grad():
        kv_ms = _time_ms(lambda: card._hmt_kv_step(inputs["ckv"], inputs["cache"], *inputs["step_args"],
                                                   learned=True))
        beam_ms = _time_ms(lambda: card._beam_step(inputs["ckv"], inputs["beam_cache"], *inputs["beam_args"]))
    return {"sessions": sessions, "kv_step_ms": kv_ms, "beam_step_ms": beam_ms}


def _step_inputs(k, d, dtype, normalised, seed, batch=BATCH, length=T_AUDIO):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    pre = (torch.randn((batch, length, C), generator=g, device=dev) * 2 + 0.5).to(dtype)
    w = (torch.randn((k, C, C), generator=g, device=dev) / (k * C) ** 0.5).to(dtype)
    bias = torch.randn(C, generator=g, device=dev) * 0.1
    if normalised:
        pf = pre.float()
        mean, inv = group_stats(pf.sum(1), pf.square().sum(1), length * C // GROUPS, GROUPS)
        gamma = torch.rand((batch, C), generator=g, device=dev) + 0.5
        beta = torch.randn((batch, C), generator=g, device=dev) * 0.1
        slope = 0.1
    else:
        mean = torch.zeros((batch, C), device=dev)
        inv = gamma = torch.ones((batch, C), device=dev)
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


def _check_sees_taps(args, lo, dilation, want, dtype):
    """``_check_step`` must refuse the plain step with the MRF taps zeroed
    on these inputs: else it could not tell a kernel that drops the taps
    from the plain version.  Raises if it does not refuse it."""
    try:
        _check_step(_no_taps(*args, lo=lo, dilation=dilation), want, dtype)
    except AssertionError:
        return
    raise AssertionError(f"the step check cannot tell a step without its taps from the plain step "
                         f"(k {args[5].shape[0]}, lo {lo}, dilation {dilation}, pre {tuple(args[0].shape)})")


def _step_bound_ms(k, dtype, batch=BATCH):
    """Least time for one step at [batch, T_AUDIO, C]: read pre, write
    pre_out, read W2 and the statistics, write the two sums; against
    2*B*T*k*C*C operations at PEAK_OPS_PER_S (fp32: three TF32 products
    each)."""
    es = torch.finfo(dtype).bits // 8
    n = batch * T_AUDIO * C
    nbytes = 2 * n * es + k * C * C * es + (4 * batch * C + C + 2 * batch * C) * 4
    ops = 2 * batch * T_AUDIO * k * C * C
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

    with torch.no_grad():
        for name in grc_kernel.launches:
            grc_kernel.launches[name] = 0
        wavs = {dtype: m(mel, spk, emo) for dtype, m in models.items()}
        torch.cuda.synchronize()
        launches = dict(grc_kernel.launches)
        wavs_plain = {dtype: m(mel, spk, emo, step=grc_kernel.grc_step_reference) for dtype, m in models.items()}
        wav_no_taps = model(mel, spk, emo, step=_no_taps)
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

    # 9. evaluation: cli eval and cli eval-clone through cli.main, fp32 (TF32
    # on before each command, which turns it off), checked and timed before
    # any trace
    with tempfile.TemporaryDirectory() as directory:
        files = _write_eval_files(directory)
        ev = _check_eval(files, directory)
        clone_ev = _check_eval_clone(files, directory)
    eval_vocoder = files["vocoder"]
    stats = ev["report"]["statistics"]
    print(f"eval: cli eval fp32 (TrainConfig(), the generator redrawn; EncoderTrainConfig() encoders and the "
          f"JUDGE_CONFIG CTC judge seeded, through their files) over {EVAL_SAMPLES} held-out formant clips padded to "
          f"{ev['mel'].shape[-1]} frames: kernel launches {ev['launches']} (9 a synthesis call, {EVAL_SAMPLES} + 1 "
          f"warm-up); report keys equal JAX's; judge ground-truth CER {ev['cer']}, ASR-BLEU {ev['status']}; "
          f"sample 0 card vs CPU errors {json.dumps({k: float(f'{v:.3g}') for k, v in ev['errs'].items()})} "
          f"(tolerances {json.dumps({k: float(f'{v:.3g}') for k, v in ev['tols'].items()})}); kernel vs plain path "
          f"max err {ev['kernel_err']:.3g} (tol 1e-4); means "
          + json.dumps({k: v["mean"] for k, v in stats.items()}))
    print(f"eval_clone: cli eval-clone fp32 at {EVAL_CLONE_SPEAKERS} speakers x {EVAL_CLONE_CONTENTS} contents: "
          f"{clone_ev['report']['n_transfer_pairs']} transfer pairs and {clone_ev['calls']} cloning calls, kernel "
          f"launches {clone_ev['launches']} (9 a call); report keys equal JAX's; kernel vs plain path at one pair "
          f"max err {clone_ev['kernel_err']:.3g} (tol 1e-4); a zero reference moves the waveform by "
          f"{clone_ev['moved']:.3g}; transfer and ablation "
          + json.dumps({k: v for k, v in clone_ev["report"].items() if not isinstance(v, str)}))
    with torch.no_grad():
        synth_ms = _time_ms(lambda: eval_vocoder(ev["mel"]))
        clone_call_ms = _time_ms(lambda: eval_vocoder(clone_ev["content_mel"], reference_mel=clone_ev["ref_mel"]))
    proc = [r["processing_time"] for r in ev["report"]["raw_results"]]
    rtf = [r["rtf"] for r in ev["report"]["raw_results"]]
    print(f"timing_eval: {smi.stdout.strip().splitlines()[0]}; synthesis of one eval sample (1 x "
          f"{ev['mel'].shape[-1]} frames, fp32) median {synth_ms:.3f} ms; the evaluator's processing_time median "
          f"{statistics.median(proc) * 1e3:.3f} ms ({json.dumps([round(p * 1e3, 3) for p in proc])} ms), rtf median "
          f"{statistics.median(rtf):.1f} audio-s/s; cli eval {ev['wall_s']:.2f} s wall; the eval-clone cloning call "
          f"(1 x {clone_ev['content_mel'].shape[-1]} content and {clone_ev['ref_mel'].shape[-1]} reference frames) "
          f"median {clone_call_ms:.3f} ms; cli eval-clone grid {clone_ev['wall_s']:.2f} s wall")

    # 10. HMT: the simultaneous beam search and cli eval-s2st at the trained
    # S2ST stack's widths, fp32 (TF32 off), checked and timed before any trace
    hmt_card, hmt_cpu = _hmt_stacks()
    hmt_programs = _check_hmt_programs(hmt_card, hmt_cpu)
    hmt_cont = _check_hmt_continuations(hmt_card, hmt_cpu)
    del hmt_cpu
    with tempfile.TemporaryDirectory() as directory:
        es = _check_eval_s2st(hmt_card, directory)
    n_hmt = sum(p.numel() for p in hmt_card.model.parameters()) + sum(
        p.numel() for p in hmt_card.code_vocoder.parameters())
    print(f"hmt: S2ST3_CONFIG stack with the transition head and UNIT_VOCODER_CONFIG unit vocoder ({n_hmt} "
          f"parameters, seeded), fp32, TF32 off; card vs CPU within 1e-4 of each output's peak: "
          + "; ".join(f"{k} {e:.3g} (tol {t:.3g})" for k, (e, t) in hmt_programs["checks"].items())
          + f"; continue_text_hmt card vs CPU: {hmt_cont['compared']} calls compared (2 gates x a call and its "
          f"resumption), {hmt_cont['equal']} equal, near ties {json.dumps(hmt_cont['near_ties'])}, KV-step float "
          f"error {hmt_cont['float_err']:.3g}, tokens {json.dumps(hmt_cont['tokens'])}; cli eval-s2st over "
          f"{HMT_SAMPLES} held-out utterances: report keys equal JAX's, GRC-kernel launches {es['launches']}, judge "
          f"ground-truth CER {es['cer']} (gate failed, speech rows skipped), policies "
          + json.dumps(es["report"]["policies"]))
    hmt_timing = _time_hmt(hmt_card, audio, hmt_programs["inputs"])
    print(f"timing_hmt: {smi.stdout.strip().splitlines()[0]}; S2TTAgent(decode='hmt') sessions over "
          f"{S2ST_AUDIO_SAMPLES / S2ST_SAMPLE_RATE:g} s of source: "
          + "; ".join(f"{k} {v['wall_s']:.3f} s wall, real-time factor {v['rtf']:.4f}, {v['tokens']} tokens, "
                      f"{v['policy_calls']} policy calls, {v['writes_before_end']} writes before the source ended"
                      for k, v in hmt_timing["sessions"].items())
          + f"; median KV HMT step ({HMT_BEAM * HMT_CANDS} rows, learned gate) {hmt_timing['kv_step_ms']:.3f} ms, beam "
          f"step ({HMT_BEAM_STEP_ROWS} rows) {hmt_timing['beam_step_ms']:.3f} ms; cli eval-s2st {es['wall_s']:.2f} s "
          f"wall, peak device memory {es['peak_mib']:.1f} MiB above what was held before it")

    # 11. the voice-cloning training pipeline: cli train-encoders, cli
    # train-clone (with the probe), an identity_finetune step and cli train on
    # the formant corpus, through cli.main, checked and timed before any trace
    with tempfile.TemporaryDirectory() as directory:
        pipe = _check_pipeline(directory)
    enc_ms = statistics.median(pipe["enc_ms"][PIPE_WARMUP:])
    clone_ms = statistics.median(pipe["clone_ms"][PIPE_WARMUP:])
    ecfg = EncoderTrainConfig()
    last = {k: float(f"{v:.4g}") for k, v in pipe["clone_rows"][-1].items() if k not in ("step", "wall_s")}
    print(f"pipeline: cli train-encoders EncoderTrainConfig() fp32 ({ecfg.batch_size} x {ecfg.segment_samples} "
          f"samples a step, {PIPE_UTTERANCES} utterances a speaker): losses finite "
          + json.dumps([{k: round(v, 4) for k, v in r.items() if "loss" in k} for r in pipe["enc_rows"]])
          + f", parameter tensors changed {pipe['changed']}, encoders.pt read back, 0 GRC launches; fp32 encoder "
          f"step card vs CPU at batch {PIPE_CHECK_BATCH}: max loss rel err {pipe['enc_check']['loss_err']:.3g} (tol "
          f"1e-4), gradients (tol {PIPE_GRAD_FRAC} of each leaf's peak, {PIPE_GRAD_L2} in L2) "
          + json.dumps({k: (float(f"{v:.3g}") if isinstance(v, float) else v) for k, v in pipe["enc_check"]["grads"].items()})
          + "; cli train-clone bf16 "
          f"(TrainConfig(), extractor at the encoders' widths, identity hinge weight 1 margin {PIPE_IDENTITY_MARGIN}, {PIPE_CONTENTS} contents): "
          f"GRC launches {pipe['clone_launches']} (0 in the train steps, 9 a probe call), probe kernel vs plain "
          f"path max err {pipe['probe_err']:.3g} (tol {pipe['probe_tol']:.3g}), last row {json.dumps(last)}; "
          f"identity_finetune: {pipe['moved']} conditioning tensors moved, {pipe['trunk']} trunk tensors bit for bit; "
          f"cli train --dataset formant --device_data bf16: losses finite "
          + json.dumps([round(r["generator_loss"], 4) for r in pipe["formant_rows"]]))
    clone_audio_s = 16 * 8192 / 16000
    print(f"timing_pipeline: {smi.stdout.strip().splitlines()[0]}; train-encoders step median {enc_ms:.3f} ms over "
          f"{PIPE_TIMED} after {PIPE_WARMUP} ({json.dumps([round(t, 3) for t in pipe['enc_ms']])} ms), "
          f"{ecfg.batch_size * ecfg.segment_samples / 16000 / enc_ms * 1e3:.1f} audio-s trained a second, command "
          f"{pipe['enc_wall']:.2f} s wall; train-clone step median {clone_ms:.3f} ms "
          f"({json.dumps([round(t, 3) for t in pipe['clone_ms']])} ms), {clone_audio_s / clone_ms * 1e3:.1f} audio-s "
          f"trained a second, command {pipe['clone_wall']:.2f} s wall, peak device memory "
          f"{pipe['clone_peak_mib']:.1f} MiB above what was held before it")

    # 12. the unit-vocoder and S2ST training paths: cli train-unit-vocoder,
    # cli train-s2st with the held-out token F1, cli eval-s2st over their run
    # directories and cli info, through cli.main, checked and timed before any
    # trace
    with tempfile.TemporaryDirectory() as directory:
        runs = _check_train_runs(directory, models[torch.float32])
    _report_train_runs(runs, smi.stdout.strip().splitlines()[0])

    # 14. serving: the app's stdlib server (cli serve without FastAPI) with
    # the bf16 vocoder route over HTTP, checked and timed before any trace
    with tempfile.TemporaryDirectory() as directory:
        serve = _check_serving(directory)
    serve_audio_s = SERVE_FRAMES * 256 / 16000
    print(f"serving: StdlibServer on port 0, engine with vocoder_checkpoint (seeded create_train_state(TrainConfig()), "
          f"the JAX initialisers' draw; make_vocoder_synth bf16) built in {serve['engine_s']:.2f} s (its vocoder "
          f"alone, built again: {serve['vocoder_s']:.2f} s); /api/health ok, "
          f"/api/models/info uses_framework_vocoder true, /api/translate/text identity; /api/synthesize/text over "
          f"a seeded [{SERVE_FRAMES}, 80] mel: the served WAV within {serve['pcm_err']:.3g} of the direct synth's "
          f"(tol one PCM step {SERVE_PCM_STEP:.3g}); wav peak {serve['peak']:.4f}, std {serve['std']:.4f}; GRC "
          f"launches a synth call {serve['launches']}, a request {serve['request_launches']}; kernel vs plain path "
          f"max err {serve['kernel_err']:.3g} (tol {serve['kernel_tol']:.3g}); the 9 kernel steps at "
          f"[1, {SERVE_FRAMES * 256}, {C}] bf16 against the plain step, on the path's inputs: max |pre_out err| "
          f"{serve['step_worst']['path'][0]:.3g}, sum rel err {serve['step_worst']['path'][1]:.3g}; on phase 3's "
          f"seeded inputs (neutral and normalised): {serve['step_worst']['seeded'][0]:.3g}, "
          f"{serve['step_worst']['seeded'][1]:.3g} (tol 2 ulp, 1e-4); the check refuses the step without its "
          f"MRF taps on all {serve['steps_checked']} inputs")
    print(f"timing_serving: {smi.stdout.strip().splitlines()[0]}; a synth call (1 x {SERVE_FRAMES} frames = "
          f"{SERVE_FRAMES * 256} samples, bf16, numpy in and out) median {serve['synth_ms']:.3f} ms over {RUNS} after "
          f"{WARMUP} ({serve_audio_s / serve['synth_ms'] * 1e3:.1f} audio-s/s); a /api/synthesize/text request's wall "
          f"median {serve['request_ms']:.3f} ms over {SERVE_REQUESTS} "
          f"({json.dumps([round(w, 3) for w in serve['request_walls_ms']])} ms)")

    # 15. parallelism: the sharded train step and the sequence-parallel
    # encoder over an NCCL group of one card, cli train under the launcher,
    # dryrun_multichip on the card and on four gloo processes; before any
    # trace
    card_line = smi.stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as directory:
        par = _check_parallel(directory)
    print(f"parallel: {card_line}; NCCL at world 1 (one rank a card): make_sharded_train_step over make_mesh(1, 1), "
          f"TrainConfig() bf16, {TRAIN_BATCH} x {TRAIN_SEGMENT} samples from make_device_sampler, "
          f"{PARALLEL_WARMUP} + {PARALLEL_STEPS} steps: losses equal to the plain step's bit for bit (cuDNN "
          f"deterministic) {json.dumps(par['losses'][-1])}; gradient all-reduces a step {par['reduces']} (one an "
          f"optimiser update); GRC kernel launches in the steps {json.dumps(par['grc_launches'])}; "
          f"conformer_forward_seq_sharded over the StreamSpeechConfig() encoder "
          f"({par['encoder_params']} parameters) at 1 x {SP_FRAMES} frames, fp32: {par['sp_err']:.3g} of the peak "
          f"from ChunkedConformer(chunked=True) (tol 1e-4); torch.distributed.run --nproc_per_node 1 cli train "
          f"--bf16 --dataset formant --device_data --max_steps 2: exit 0, metrics.jsonl within {par['cli_err']:.3g} "
          f"relative of the plain command's (tol 1e-4); {par['dryrun_lines'][0]} (card); gloo CPU check of the "
          f"card machine's torch.distributed, not a timing: {par['dryrun_lines'][1]}")
    print(f"timing_parallel: {card_line}; train step median over {PARALLEL_TIMED} after {PARALLEL_WARMUP}, "
          f"alternating: sharded {par['step_ms']['mesh']:.3f} ms, plain {par['step_ms']['plain']:.3f} ms "
          f"({json.dumps({k: [round(t, 3) for t in v] for k, v in par['times'].items()})} ms); sequence-parallel "
          f"encoder at world 1 {par['sp_ms']:.3f} ms, ChunkedConformer {par['plain_encoder_ms']:.3f} ms (median of "
          f"5, CUDA events); cli train wall {par['cli_walls']['launched']:.2f} s launched, "
          f"{par['cli_walls']['plain']:.2f} s plain; dryrun_multichip(1) {par['dryrun_card_s']:.2f} s, "
          f"dryrun_multichip(4, cpu) {par['dryrun_gloo_s']:.2f} s wall")

    # 16. cli bench: the root bench.py's five configs on the card through
    # cli.main, its contract lines and each config's GRC launches; before any
    # trace
    bench_run = _check_bench()
    bench_configs = bench_run["record"]["configs"]
    print(f"bench: {card_line}; cli bench exit 0 in {bench_run['wall_s']:.2f} s wall: "
          f"{json.dumps(bench_run['line'])}; flagship 8 x 256 bf16 "
          f"{bench_configs['flagship_odconv_grc_film']['ms_per_call']:.3f} ms a call "
          f"(rtf {bench_configs['flagship_odconv_grc_film']['rtf']:.1f}); hifigan_v1 "
          f"{bench_configs['hifigan_v1']['ms_per_call']:.3f} ms (rtf {bench_configs['hifigan_v1']['rtf']:.1f}); "
          f"conditioned_auto_embeddings {bench_configs['conditioned_auto_embeddings']['ms_per_call']:.3f} ms "
          f"(rtf {bench_configs['conditioned_auto_embeddings']['rtf']:.1f}); gan_train_step 4 x 8192 "
          f"{bench_configs['gan_train_step']['ms_per_step']:.3f} ms a step; gan_train_step_production 16 x 8192, "
          f"32 steps a call, {bench_configs['gan_train_step_production']['ms_per_step']:.3f} ms a step "
          f"({bench_configs['gan_train_step_production']['audio_sec_per_sec']:.1f} audio-s trained a second); "
          f"each a window of calls between CUDA events over its calls; GRC launches by config {json.dumps(bench_run['launches'])}; "
          f"device {json.dumps(bench_run['record']['device'])}")

    # 13. traces: where the device time goes, in the forward, the cloning call,
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
        hmt_trace = _trace(lambda: run_streaming_session(S2TTAgent(hmt_card, decode="hmt", hmt_transition="learned"),
                                                         audio, sample_rate=S2ST_SAMPLE_RATE,
                                                         segment_size_ms=S2ST_SEGMENT_MS), calls=1)
    hmt_trace["launches_per_policy_call"] = (hmt_trace["launches_per_call"]
                                             / hmt_timing["sessions"]["learned"]["policy_calls"])
    print("trace: " + json.dumps({"call": "hmt_learned_session", **hmt_trace}))
    del hmt_card
    with torch.no_grad():
        print("trace: " + json.dumps({"call": "eval_clone_call", **_trace(
            lambda: eval_vocoder(clone_ev["content_mel"], reference_mel=clone_ev["ref_mel"]))}))
    _reset_launches()
    content, ref = pipe["banks"]
    clone_gen = torch.Generator(device="cuda").manual_seed(4)
    clone_trace = _trace(lambda: pipe["step"](pipe["state"], clone_gen, content, ref), calls=1)
    if any(grc_kernel.launches.values()):
        raise AssertionError(f"the traced cloning train step launched the GRC kernels {grc_kernel.launches}")
    print("trace: " + json.dumps({"call": "cloning_train_step", **clone_trace}))
    del pipe
    _reset_launches()
    rec = runs["uv_trace"]
    uv_gen = torch.Generator(device="cuda").manual_seed(5)
    uv_trace = _trace(lambda: rec["step"](rec["state"], uv_gen, rec["args"][1]), calls=1)
    rec = runs["s2_trace"]
    s2_gen = torch.Generator(device="cuda").manual_seed(5)
    s2_trace = _trace(lambda: rec["step"](rec["state"], s2_gen), calls=1)
    if any(grc_kernel.launches.values()):
        raise AssertionError(f"the traced unit-vocoder and S2ST train steps launched the GRC kernels "
                             f"{grc_kernel.launches}")
    print("trace: " + json.dumps({"call": "unit_vocoder_train_step", **uv_trace}))
    print("trace: " + json.dumps({"call": "s2st_train_step", **s2_trace}))
    del runs, rec
    _reset_launches()
    serve_trace = _trace(lambda: serve["synth"](serve["mel"]))
    if grc_kernel.launches["grc_step_bf16"] != 9 * (TRACED_FORWARDS + 1):
        raise AssertionError(f"the traced synth calls launched the GRC kernels {grc_kernel.launches}")
    print("trace: " + json.dumps({"call": "serving_synth", **serve_trace}))
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
            "launches_by_path": {"flagship_forward": launches[name], "serving_synth": serve["launches"][name],
                                 "sharded_train_step": par["grc_launches"][name],
                                 "cli_bench_forward": bench_run["per_forward"][name]},
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
