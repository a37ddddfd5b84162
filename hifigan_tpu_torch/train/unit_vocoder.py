"""Unit-vocoder (CodeHiFiGAN) GAN training on the translated corpus.

Counterpart of ``hifigan_tpu/train/unit_vocoder.py``: the toy translation
(:mod:`hifigan_tpu_torch.train.s2st_task`) maps a source phone plan to a
translated plan, the formant corpus renders that plan as speech, and the
(units, durations, waveform) triples train the ``CodeVocoder``:

* units are translated phone ids (pau = 0 is the silence unit);
* durations come from cumulative frame rounding at the vocoder's frame
  rate, so unit boundaries drift less than one frame from the audio;
* the generator expands units by the TEACHER durations while its
  duration predictor is supervised on log-durations;
* the GAN losses are the vocoder trainer's (LSGAN, deep feature matching,
  mel L1, the optional multi-resolution STFT term), over fixed windows of
  ``window_units`` units with the real audio masked past the window's
  valid samples.

A step draws its windows with a ``torch.Generator`` on the bank's device
(JAX draws them with its PRNG inside the jitted step), or takes drawn
windows, so that the tests feed it what JAX's sampler drew.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.discriminators import Discriminators
from hifigan_tpu_torch.train.corpus import PHONE_TO_ID, PHONES, FormantSpeechCorpus
from hifigan_tpu_torch.train.s2st_task import _PERM
from hifigan_tpu_torch.train.state import GanTrainState, TrainConfig, make_optimizer
from hifigan_tpu_torch.train.train_step import audio_to_mel, discriminator_phase, fuse_steps, generator_losses

UNIT_PLAN_KEY_BASE = 70_000_000
FRAME_SAMPLES = 256          # default 16 ms at 16 kHz (upsample 8·8·2·2)
FRAME_SECONDS = FRAME_SAMPLES / 16_000


def upsample_ratio(code: CodeVocoderConfig) -> int:
    r = 1
    for f in code.upsample_factors:
        r *= f
    return r


def translate_plan(plan: list[tuple[str, float]]) -> list[tuple[str, float]]:
    """Source plan → translated plan: per pause-delimited word, reverse the
    (phone, duration) pairs and map phones through the toy translation's
    fixed permutation (``s2st_task._PERM``)."""
    out: list[tuple[str, float]] = []
    word: list[tuple[str, float]] = []
    for phone, dur in plan:
        if phone == "pau":
            out.extend((PHONES[_PERM[PHONE_TO_ID[p]]], d) for p, d in reversed(word))
            word = []
            out.append((phone, dur))
        else:
            word.append((phone, dur))
    out.extend((PHONES[_PERM[PHONE_TO_ID[p]]], d) for p, d in reversed(word))
    return out


def plan_units_durations(plan: list[tuple[str, float]], max_dur: int,
                         frame_seconds: float = FRAME_SECONDS) -> Tuple[np.ndarray, np.ndarray]:
    """Units (phone ids, pau = 0) and per-unit frame durations by cumulative
    rounding (total drift under one frame), each clipped to ``[1, max_dur]``."""
    units, durs = [], []
    cum_s, cum_f = 0.0, 0
    for phone, dur in plan:
        cum_s += dur
        boundary = int(round(cum_s / frame_seconds))
        d = max(1, min(boundary - cum_f, max_dur))
        cum_f += d
        units.append(PHONE_TO_ID[phone])
        durs.append(d)
    return np.array(units, np.int32), np.array(durs, np.int32)


@dataclass(frozen=True)
class UnitVocoderTaskConfig:
    n_utterances: int = 256
    n_speakers: int = 32
    max_units: int = 72
    window_units: int = 16
    batch_size: int = 8
    code: CodeVocoderConfig = CodeVocoderConfig(unit_vocab_size=32, embed_dim=128, max_duration_per_unit=16)

    @property
    def frame_samples(self) -> int:
        return upsample_ratio(self.code)

    @property
    def frame_seconds(self) -> float:
        return self.frame_samples / 16_000

    @property
    def window_samples(self) -> int:
        return self.window_units * self.code.max_duration_per_unit * self.frame_samples


def build_unit_vocoder_bank(cfg: UnitVocoderTaskConfig, *, idx_offset: int = 0) -> dict:
    """Render translated utterances into fixed-shape arrays: units ``[N,
    U]``, durs ``[N, U]``, cumdur ``[N, U + 1]`` (frame prefix sums), counts
    ``[N]``, wav ``[N, S]``; ``S`` is the longest rendition rounded up to
    128 samples plus one window of slack.  A draw with more than
    ``max_units`` or fewer than ``window_units`` units is skipped."""
    corpus = FormantSpeechCorpus(n_speakers=cfg.n_speakers)
    N, U = cfg.n_utterances, cfg.max_units
    units = np.zeros((N, U), np.int32)
    durs = np.ones((N, U), np.int32)
    counts = np.zeros(N, np.int32)
    wavs = []
    i, draw = 0, 0
    while i < N:
        spk = i % cfg.n_speakers
        _w, plan, ar = corpus.utterance(spk, 0, content=UNIT_PLAN_KEY_BASE + idx_offset + draw, return_plan=True)
        draw += 1
        t_plan = translate_plan(plan)
        u, d = plan_units_durations(t_plan, cfg.code.max_duration_per_unit, cfg.frame_seconds)
        if len(u) > U or len(u) < cfg.window_units:
            continue
        wav = corpus.render_plan(spk, t_plan, arousal=ar, seed=idx_offset + i)
        units[i, : len(u)] = u
        durs[i, : len(u)] = d
        counts[i] = len(u)
        wavs.append(wav)
        i += 1
    S = max(len(w) for w in wavs)
    S = -(-S // 128) * 128 + cfg.window_samples  # slack for window slicing
    wav_bank = np.zeros((N, S), np.float32)
    for j, w in enumerate(wavs):
        wav_bank[j, : len(w)] = w
    cumdur = np.zeros((N, U + 1), np.int32)
    cumdur[:, 1:] = np.cumsum(durs, axis=1)
    return dict(units=units, durs=durs, cumdur=cumdur, counts=counts, wav=wav_bank)


def gather_windows(bank: dict, rows: torch.Tensor, wstart: torch.Tensor, cfg: UnitVocoderTaskConfig) -> dict:
    """``{"units", "durs" [B, Uw], "audio" [B, Sw]}``: the ``window_units``
    units and durations of each ``rows`` from ``wstart``, and ``Sw =
    window_samples`` samples from the window's first frame.  Each start is
    clamped so that its slice fits, as ``jax.lax.dynamic_slice`` clamps
    (the bank's slack keeps a drawn window from needing it)."""
    Uw, Sw, fs = cfg.window_units, cfg.window_samples, cfg.frame_samples
    dev = bank["units"].device
    rows, wstart = rows.to(dev).long(), wstart.to(dev).long()
    U, S = bank["units"].shape[1], bank["wav"].shape[1]
    s = wstart.clamp(0, U - Uw)[:, None] + torch.arange(Uw, device=dev)
    start = (bank["cumdur"][rows, wstart.clamp(0, U)].long() * fs).clamp(0, S - Sw)
    return {"units": bank["units"][rows[:, None], s], "durs": bank["durs"][rows[:, None], s],
            "audio": bank["wav"][rows[:, None], start[:, None] + torch.arange(Sw, device=dev)]}


def make_unit_vocoder_sampler(cfg: UnitVocoderTaskConfig) -> Callable[[torch.Generator, dict], dict]:
    """``sample(gen, bank) → gather_windows(...)`` of ``batch_size`` uniform
    rows, each window's first unit uniform over ``max(count − Uw, 1)``;
    ``gen`` is a ``torch.Generator`` on the bank's device."""
    B, Uw = cfg.batch_size, cfg.window_units

    def sample(gen: torch.Generator, bank: dict) -> dict:
        dev = bank["units"].device
        rows = torch.randint(0, bank["units"].shape[0], (B,), generator=gen, device=dev)
        span = (bank["counts"][rows].long() - Uw).clamp_min(1)
        wstart = (torch.rand(B, generator=gen, device=dev) * span).long()
        return gather_windows(bank, rows, wstart, cfg)

    return sample


def make_unit_vocoder_train_step(
    train_cfg: TrainConfig,
    task_cfg: UnitVocoderTaskConfig,
    *,
    deep_feature_matching: bool = True,
    dur_loss_weight: float = 1.0,
    multi_steps: int = 1,
) -> Callable[..., Tuple[GanTrainState, dict]]:
    """``step(state, batch, bank=None) → (state, metrics)``; ``state`` (from
    :func:`create_unit_vocoder_state`) is updated in place and returned.

    ``batch`` is a ``torch.Generator`` on the bank's device, with which
    :func:`make_unit_vocoder_sampler` draws the windows from ``bank`` (the
    dict of :func:`build_unit_vocoder_bank`'s arrays as tensors), or drawn
    windows ``{"units", "durs" [B, Uw], "audio" [B, Sw]}``.  One step:

    1. ``real`` = the audio masked past ``Σ durs · frame_samples`` samples;
       ``fake`` = the generator's first ``Sw`` samples with the teacher
       durations (not masked), and its log-durations;
    2. one discriminator update on ``(real, fake.detach())``;
    3. the generator's loss against the updated discriminators:
       adversarial, feature matching (every layer's maps when
       ``deep_feature_matching``), mel L1 between the two log-mels, the
       STFT term when weighted, and ``dur_loss_weight · mean((log_dur −
       log(durs + 1))²)``.

    Metrics (0-dim fp32 tensors): ``generator_loss``,
    ``discriminator_loss``, ``adv_loss``, ``fm_loss``, ``mel_loss``,
    ``dur_loss`` (and ``stft_loss``).  ``multi_steps > 1``: ``batch`` is a
    generator (each step draws its own windows) or a list of
    ``multi_steps`` drawn batches; the metrics are the window's means."""
    w = train_cfg.loss_weights
    Sw, fs = task_cfg.window_samples, task_cfg.frame_samples
    sample = make_unit_vocoder_sampler(task_cfg)

    def one_step(state: GanTrainState, batch, bank) -> dict:
        if isinstance(batch, torch.Generator):
            batch = sample(batch, bank)
        dev = state.device
        units = torch.as_tensor(batch["units"], device=dev).long()
        durs = torch.as_tensor(batch["durs"], device=dev).long()
        audio = torch.as_tensor(batch["audio"], device=dev)
        n_valid = durs.sum(1) * fs
        smask = (torch.arange(Sw, device=dev)[None, :] < n_valid[:, None]).float()
        real = audio * smask
        wav, _d, _n, log_dur = state.vocoder(units, durations=durs, return_log_dur=True)
        fake = wav[:, 0, :Sw]

        d_loss = discriminator_phase(state, real, fake, w)
        total, metrics = generator_losses(state.discriminators, real, fake, audio_to_mel(fake, train_cfg),
                                          audio_to_mel(real, train_cfg), w, deep_feature_matching)
        dur_loss = (log_dur - torch.log(durs.float() + 1.0)).square().mean()
        total = total + dur_loss_weight * dur_loss
        state.gen_opt.zero_grad()
        total.backward()
        state.gen_opt.step()
        state.step += 1
        return {"generator_loss": total.detach(), "discriminator_loss": d_loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}, "dur_loss": dur_loss.detach()}

    def step(state: GanTrainState, batch, bank: dict | None = None) -> Tuple[GanTrainState, dict]:
        return state, one_step(state, batch, bank)

    return fuse_steps(step, multi_steps)


def create_unit_vocoder_state(
    train_cfg: TrainConfig = TrainConfig(),
    task_cfg: UnitVocoderTaskConfig = UnitVocoderTaskConfig(),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> GanTrainState:
    """A ``GanTrainState`` holding the ``CodeVocoder`` at ``task_cfg.code``
    and the MPD/MSD discriminators, weights drawn from ``seed`` by the JAX
    package's initialisers, on ``device``, computing in ``dtype``; two
    fresh ``make_optimizer(params, train_cfg)`` optimisers."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    code_vocoder = CodeVocoder(task_cfg.code, dtype, gen=gen).to(device)
    discs = Discriminators(dtype=dtype, gen=gen).to(device)
    return GanTrainState(code_vocoder, discs, make_optimizer(code_vocoder.parameters(), train_cfg),
                         make_optimizer(discs.parameters(), train_cfg))
