"""Discriminative pre-training of the conditioning encoders.

Counterpart of ``hifigan_tpu/train/encoder_pretrain.py``: ECAPA-TDNN learns
speaker identity over the formant corpus's 32 speakers (an AAM-softmax over
its classifier head's normalised columns, and optionally a same-speaker
pair-cosine pull), Emotion2Vec learns arousal in :data:`N_AROUSAL_BINS`
classes (cross-entropy through its head), both from one mel of crops drawn
from a labelled bank in device memory.  Then the helpers that strip a head
from a parameter tree and graft the encoders into a vocoder's extractor.
The port's parameter trees are state dicts (dotted names, the JAX leaves'
paths).

Each step runs two backward passes and two updates: Adam at
``learning_rate`` for ECAPA-TDNN, and for Emotion2Vec Adam under optax's
``join_schedules([linear 0 → emo_learning_rate over emo_warmup_steps,
constant])``.  The crops are drawn with a ``torch.Generator`` on the bank's
device (JAX draws them with its PRNG inside the jitted step); a step also
takes an explicit batch, so that the tests feed it the crops JAX drew.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.models.embeddings import EcapaTdnn, Emotion2Vec
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus
from hifigan_tpu_torch.train.state import ScheduledAdam
from hifigan_tpu_torch.train.train_step import audio_to_mel, fuse_steps

N_AROUSAL_BINS = 8
ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults


def arousal_bin(arousal) -> np.ndarray:
    """Quantise arousal ∈ [0.2, 1.0] into N_AROUSAL_BINS classes."""
    a = (np.asarray(arousal) - 0.2) / 0.8
    return np.clip((a * N_AROUSAL_BINS).astype(np.int32), 0, N_AROUSAL_BINS - 1)


def build_labelled_bank(
    *,
    n_speakers: int = 32,
    utterances_per_speaker: int = 12,
    pad_to_multiple: int = 128,
    corpus: FormantSpeechCorpus | None = None,
    idx_offset: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A labelled corpus, speaker-major: ``(bank [N, L], lengths [N],
    speaker [N], arousal_bin [N])``, rows zero-padded to a multiple of
    ``pad_to_multiple``.  ``idx_offset`` shifts the utterance ids (held-out
    sets use a disjoint range)."""
    corpus = corpus or FormantSpeechCorpus(n_speakers=n_speakers)
    utts, spks, bins = [], [], []
    for s in range(n_speakers):
        for i in range(utterances_per_speaker):
            audio, _plan, arousal = corpus.utterance(s, idx_offset + i, return_plan=True)
            utts.append(audio)
            spks.append(s)
            bins.append(int(arousal_bin(arousal)))
    lengths = np.array([len(u) for u in utts], np.int32)
    L = -(-int(lengths.max()) // pad_to_multiple) * pad_to_multiple
    bank = np.zeros((len(utts), L), np.float32)
    for i, u in enumerate(utts):
        bank[i, : len(u)] = u
    return bank, lengths, np.array(spks, np.int32), np.array(bins, np.int32)


@dataclass(frozen=True)
class EncoderTrainConfig:
    """The JAX package's encoder pre-training config.  The *judge*
    Emotion2Vec is 3 layers × 256 with 4 heads (the 6 × 512 class default
    could not learn the arousal task); ECAPA-TDNN is 512 wide."""

    n_speakers: int = 32
    segment_samples: int = 16_384
    batch_size: int = 32
    learning_rate: float = 1e-3
    mel: MelConfig = MelConfig()
    ecapa_channels: int = 512
    emo_hidden: int = 256
    emo_layers: int = 3
    emo_heads: int = 4
    aam_margin: float = 0.2
    aam_scale: float = 30.0
    emo_learning_rate: float = 1e-4
    emo_warmup_steps: int = 500
    spk_pair_weight: float = 0.0


def build_models(cfg: EncoderTrainConfig, dtype=torch.float32, *, gen: torch.Generator,
                 heads: bool = False) -> tuple[EcapaTdnn, Emotion2Vec]:
    """ECAPA-TDNN and Emotion2Vec at ``cfg``'s widths over ``cfg.mel``'s
    mels, drawn from ``gen``; with ``heads``, their classifier heads
    (``cfg.n_speakers`` speakers, :data:`N_AROUSAL_BINS` arousal bins), as
    the JAX package's ``build_models`` has them."""
    n_mels = cfg.mel.n_mels
    ecapa = EcapaTdnn(n_mels, cfg.ecapa_channels, dtype=dtype, gen=gen,
                      num_speakers=cfg.n_speakers if heads else None)
    emo = Emotion2Vec(n_mels, cfg.emo_hidden, num_layers=cfg.emo_layers, num_heads=cfg.emo_heads, dtype=dtype,
                      gen=gen, num_emotions=N_AROUSAL_BINS if heads else None)
    return ecapa, emo


def emo_learning_rate(cfg: EncoderTrainConfig, count: int) -> float:
    """optax's ``join_schedules([linear_schedule(0, emo_lr, warmup),
    constant_schedule(emo_lr)], [warmup])`` at update ``count``: linear
    from 0 below the boundary, in fp32 as optax computes it (``(0 − lr)·(1 −
    count / warmup) + lr``), the constant from the boundary on."""
    peak, warmup = cfg.emo_learning_rate, cfg.emo_warmup_steps
    if count >= warmup:
        return peak
    frac = np.float32(1) - np.float32(count) / np.float32(warmup)
    return float(np.float32(-peak) * frac + np.float32(peak))


def ecapa_optimizer(params, cfg: EncoderTrainConfig) -> ScheduledAdam:
    """``optax.adam(cfg.learning_rate)``."""
    return ScheduledAdam(params, lambda count: cfg.learning_rate, betas=ADAM_BETAS)


def emo_optimizer(params, cfg: EncoderTrainConfig) -> ScheduledAdam:
    """Warmup-then-constant Adam for the post-norm Emotion2Vec branch
    (:func:`emo_learning_rate`)."""
    return ScheduledAdam(params, lambda count: emo_learning_rate(cfg, count), betas=ADAM_BETAS)


@dataclass
class EncoderTrainState:
    """Both encoders with their heads, their optimisers and the step;
    ``state_dict`` is what a checkpoint holds."""

    ecapa: EcapaTdnn
    emo: Emotion2Vec
    ecapa_opt: ScheduledAdam = field(repr=False)
    emo_opt: ScheduledAdam = field(repr=False)
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.ecapa.parameters()).device

    def state_dict(self) -> dict:
        return {"step": self.step, "ecapa": self.ecapa.state_dict(), "emo": self.emo.state_dict(),
                "ecapa_opt": self.ecapa_opt.state_dict(), "emo_opt": self.emo_opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.ecapa.load_state_dict(state["ecapa"])
        self.emo.load_state_dict(state["emo"])
        self.ecapa_opt.load_state_dict(state["ecapa_opt"])
        self.emo_opt.load_state_dict(state["emo_opt"])
        self.step = int(state["step"])


def create_encoder_state(
    cfg: EncoderTrainConfig = EncoderTrainConfig(),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> EncoderTrainState:
    """Both encoders with their heads at ``cfg``'s widths, weights drawn
    from ``seed`` by the JAX package's initialisers, on ``device``,
    computing in ``dtype``; fresh optimisers."""
    device = resolve_device(device)
    ecapa, emo = build_models(cfg, dtype, gen=torch.Generator().manual_seed(seed), heads=True)
    ecapa, emo = ecapa.to(device), emo.to(device)
    return EncoderTrainState(ecapa, emo, ecapa_optimizer(ecapa.parameters(), cfg), emo_optimizer(emo.parameters(), cfg))


def make_encoder_sampler(
    cfg: EncoderTrainConfig,
    lengths: torch.Tensor,
    speakers: torch.Tensor,
    arousal_bins: torch.Tensor,
) -> Callable[[torch.Generator, torch.Tensor], dict]:
    """``sample(gen, bank) → {"audio", "pair", "speaker", "arousal_bin"}``:
    ``cfg.batch_size`` uniform utterances of ``bank [N, L]`` (true lengths,
    speakers and arousal bins ``[N]``, on the bank's device), each cropped
    to ``cfg.segment_samples`` at an offset uniform over ``max(length −
    segment, 1)``; with ``cfg.spk_pair_weight > 0`` also ``"pair"``, a crop
    of another utterance of the same speaker (the bank is speaker-major),
    else None.  ``gen`` is a ``torch.Generator`` on the bank's device."""
    seg, batch = cfg.segment_samples, cfg.batch_size
    lengths, speakers, arousal_bins = lengths.long(), speakers.long(), arousal_bins.long()

    def crop_at(bank, utt, gen):
        if bank.shape[-1] < seg:
            raise ValueError(f"the bank's rows ({bank.shape[-1]} samples) are shorter than a crop ({seg})")
        span = (lengths[utt] - seg).clamp_min(1)
        off = (torch.rand(batch, generator=gen, device=bank.device) * span).long()
        return bank[utt[:, None], off[:, None] + torch.arange(seg, device=bank.device)]

    def sample(gen: torch.Generator, bank: torch.Tensor) -> dict:
        n = bank.shape[0]
        utt = torch.randint(0, n, (batch,), generator=gen, device=bank.device)
        crops = crop_at(bank, utt, gen)
        pair = None
        if cfg.spk_pair_weight > 0:
            u_per = n // cfg.n_speakers
            base = utt // u_per * u_per
            shift = torch.randint(1, u_per, (batch,), generator=gen, device=bank.device)
            pair = crop_at(bank, base + (utt - base + shift) % u_per, gen)
        return {"audio": crops, "pair": pair, "speaker": speakers[utt], "arousal_bin": arousal_bins[utt]}

    return sample


def make_encoder_train_step(
    cfg: EncoderTrainConfig,
    bank: torch.Tensor,
    lengths,
    speakers,
    arousal_bins,
) -> Callable[..., tuple[EncoderTrainState, dict]]:
    """``step(state, batch) → (state, metrics)``; ``state`` is updated in
    place and returned.

    ``batch`` is a ``torch.Generator`` on the bank's device, with which
    :func:`make_encoder_sampler` draws the step's crops from ``bank``, or a
    drawn batch ``{"audio" [B, T],
    "pair" [B, T] or None, "speaker" [B], "arousal_bin" [B]}``.  The mel of
    the first ``T // hop`` frames feeds both encoders:

    - ECAPA-TDNN: AAM-softmax, ``cos = emb @ (W / ‖W‖_col)`` over the
      head's kernel (its bias is read by nothing), ``logits = s·(cos −
      m·onehot)``, cross-entropy; with a pair, ``+ spk_pair_weight·(1 −
      mean cos(emb, emb_pair))``;
    - Emotion2Vec: cross-entropy of its head's logits.

    Metrics (0-dim fp32 tensors): ``speaker_loss``, ``speaker_acc``,
    ``speaker_pair_cos`` (0 without pairs), ``emotion_loss``,
    ``emotion_acc`` and ``emotion_acc_near`` (within one bin)."""
    device = bank.device
    sample = make_encoder_sampler(cfg, *(torch.as_tensor(a, device=device) for a in (lengths, speakers, arousal_bins)))

    def ecapa_loss(ecapa, mel, pair_mel, spk_y):
        emb = ecapa(mel)
        w = ecapa.classifier.kernel
        w = w / w.norm(dim=0, keepdim=True).clamp_min(1e-9)
        cos = (emb @ w).float()
        onehot = F.one_hot(spk_y, cos.shape[-1]).float()
        loss = F.cross_entropy(cfg.aam_scale * (cos - cfg.aam_margin * onehot), spk_y)
        acc = (cos.argmax(-1) == spk_y).float().mean()
        pair_cos = torch.zeros((), device=mel.device)
        if pair_mel is not None:
            pair_cos = (emb.float() * ecapa(pair_mel).float()).sum(-1).mean()
            loss = loss + cfg.spk_pair_weight * (1.0 - pair_cos)
        return loss, acc, pair_cos

    def emo_loss(emo, mel, emo_y):
        _utt, logits = emo(mel, train=True)
        loss = F.cross_entropy(logits.float(), emo_y)
        pred = logits.argmax(-1)
        return loss, (pred == emo_y).float().mean(), ((pred - emo_y).abs() <= 1).float().mean()

    def step(state: EncoderTrainState, batch):
        if isinstance(batch, torch.Generator):
            batch = sample(batch, bank)
        dev = state.device
        mel = audio_to_mel(torch.as_tensor(batch["audio"], device=dev), cfg)
        pair = batch.get("pair")
        pair_mel = None if pair is None else audio_to_mel(torch.as_tensor(pair, device=dev), cfg)
        spk_y = torch.as_tensor(batch["speaker"], device=dev).long()
        emo_y = torch.as_tensor(batch["arousal_bin"], device=dev).long()

        sl, sa, spc = ecapa_loss(state.ecapa, mel, pair_mel, spk_y)
        state.ecapa_opt.zero_grad()
        sl.backward()
        el, ea, en = emo_loss(state.emo, mel, emo_y)
        state.emo_opt.zero_grad()
        el.backward()
        state.ecapa_opt.step()
        state.emo_opt.step()
        state.step += 1
        metrics = {"speaker_loss": sl, "speaker_acc": sa, "speaker_pair_cos": spc,
                   "emotion_loss": el, "emotion_acc": ea, "emotion_acc_near": en}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_fused_encoder_step(step_fn: Callable, multi_steps: int = 1) -> Callable:
    """``fused(state, batches)``: ``multi_steps`` encoder steps in one call
    (:func:`~hifigan_tpu_torch.train.train_step.fuse_steps`).  ``batches``: a
    ``torch.Generator`` (each step draws its own crops with it) or a list of
    ``multi_steps`` drawn batches; with ``multi_steps == 1``, whatever
    ``step_fn`` takes."""
    return fuse_steps(step_fn, multi_steps)


def strip_classifier(params: Mapping) -> dict:
    """``params`` (a state dict) without the classifier head's entries,
    so that it matches the inference-mode encoder."""
    return {k: v for k, v in params.items() if k.split(".")[0] != "classifier"}


def graft_into_extractor(gen_params: Mapping, ecapa_params: Mapping, emo_params: Mapping) -> dict:
    """A new vocoder state dict whose extractor subtrees
    (``embedding_extractor.ecapa`` / ``embedding_extractor.emotion2vec``)
    are replaced by the encoders' (classifier heads stripped); the input is
    left as it is.  The encoders' widths must be the extractor's: the judge
    Emotion2Vec (3 × 256) fits only a vocoder built at those widths."""
    out = {k: v for k, v in gen_params.items()
           if not k.startswith(("embedding_extractor.ecapa.", "embedding_extractor.emotion2vec."))}
    for prefix, params in (("ecapa", ecapa_params), ("emotion2vec", emo_params)):
        out.update({f"embedding_extractor.{prefix}.{k}": v for k, v in strip_classifier(params).items()})
    return out
