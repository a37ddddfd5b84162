"""Self-contained paired training task for the StreamSpeech S2ST stack.

Counterpart of ``hifigan_tpu/train/s2st_task.py``.  The formant corpus
knows its own phone plan, and a deterministic toy translation defines a
target language: within each pause-delimited word the phone sequence is
reversed and mapped through a fixed phone permutation.  The multitask
objective: source CTC (the phone transcript), target CTC (the translated
tokens), unit CTC over the T2U encoder's 8x upsampling, the teacher-forced
decoder's cross-entropy under a random source-prefix cross-attention mask,
unit CTC over the decoder's features, and the class-balanced BCE of the
learned READ/WRITE transition head on the prefix-masked rows.

Token space: ``0`` = CTC blank / pad, ``1`` = BOS, ``2`` = EOS,
``3 + (phone_id - 1)`` = phone tokens (pau never surfaces as a token).
Unit space: ``0`` = blank / pad, ``1 + perm(phone) - 1`` = unit ids.

CTC is ``F.ctc_loss`` in float64 (:func:`ctc_loss`), which equals
``optax.ctc_loss`` on every row whose labels fit its frames; on a row that
does not (:func:`ctc_min_frames`) optax returns a finite value near its
``log_epsilon`` of 1e5 and torch returns inf.  So :func:`build_s2st_bank`
refuses such a row: JAX's banks hold none
(``tests/test_torch_s2st_train.py``).

A step draws its rows and prefix masks with a ``torch.Generator`` on the
bank's device (JAX draws them with its PRNG inside the jitted step), or
takes drawn ones, so that the tests feed it what JAX drew.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.ops.stft import _hann, mel_filterbank
from hifigan_tpu_torch.train.corpus import PHONES, FormantSpeechCorpus, plan_phone_ids
from hifigan_tpu_torch.train.state import ScheduledAdam, warmup_cosine_decay
from hifigan_tpu_torch.train.train_step import fuse_steps

BLANK = 0
BOS = 1
EOS = 2
TOKEN_OFFSET = 3
N_PHONES = len(PHONES)  # includes pau at id 0


def phone_permutation(seed: int = 1234) -> np.ndarray:
    """Fixed permutation over non-pau phone ids 1..N-1 (index 0 unused)."""
    rng = np.random.default_rng(seed)
    perm = np.zeros(N_PHONES, np.int32)
    perm[1:] = rng.permutation(np.arange(1, N_PHONES))
    return perm


_PERM = phone_permutation()


def source_tokens(phone_ids: np.ndarray) -> np.ndarray:
    """ASR transcript: non-pau phones → token ids."""
    p = phone_ids[phone_ids != 0]
    return (TOKEN_OFFSET + p - 1).astype(np.int32)


def translate(phone_ids: np.ndarray) -> np.ndarray:
    """Toy translation: per pause-delimited word, reverse the phone order
    and map through the fixed permutation."""
    out: list[int] = []
    word: list[int] = []
    for p in phone_ids:
        if p == 0:
            out.extend(TOKEN_OFFSET + _PERM[q] - 1 for q in reversed(word))
            word = []
        else:
            word.append(int(p))
    out.extend(TOKEN_OFFSET + _PERM[q] - 1 for q in reversed(word))
    return np.array(out, np.int32)


def target_units(phone_ids: np.ndarray) -> np.ndarray:
    """Unit sequence: translated phones in unit space (1-based)."""
    toks = translate(phone_ids)
    return (toks - TOKEN_OFFSET + 1).astype(np.int32)


def small_config(vocab_size: int = 32, unit_vocab: int = 32) -> StreamSpeechConfig:
    """Compact trainable profile (architecture identical, smaller dims)."""
    return StreamSpeechConfig(
        hidden_dim=256, encoder_layers=6, decoder_layers=3, num_heads=4,
        vocab_size=vocab_size, unit_vocab_size=unit_vocab, chunk_size=8,
        vocoder_hidden=128, vocoder_upsample=(8, 8, 2, 2),
        ecapa_channels=64, emo_hidden=64, emo_layers=1,
    )


@dataclass(frozen=True)
class S2STTaskConfig:
    n_utterances: int = 512
    n_speakers: int = 32
    max_seconds: float = 4.0
    max_src_tokens: int = 56
    max_tgt_tokens: int = 56
    batch_size: int = 16
    learning_rate: float = 3e-4
    warmup_steps: int = 500
    prefix_mask_prob: float = 0.5
    # lower bound of the sampled source-prefix fraction on masked rows
    prefix_min_frac: float = 0.25
    # fbank (the streaming extractor's: 25 ms window / 10 ms shift)
    sample_rate: int = 16_000
    hop: int = 160
    win: int = 400

    @property
    def n_frames(self) -> int:
        return int(self.max_seconds * self.sample_rate) // self.hop

    @property
    def n_samples(self) -> int:
        return (self.n_frames - 1) * self.hop + self.win


def batched_fbank(audio: torch.Tensor, n_frames_total: int, hop: int, win: int, n_mels: int = 80,
                  sample_rate: int = 16_000, valid_frames: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, S] → [B, T, n_mels]`` log-fbank with per-utterance CMVN.

    ``T = n_frames_total`` frames of ``win`` samples every ``hop``, not
    centred (``S`` must hold ``(T - 1)·hop + win`` samples), a periodic
    Hann window, ``rfft`` at the next power of two, power through the
    Slaney filterbank from 20 Hz to half the rate, ``log(max(·, 1e-10))``.
    CMVN with the population std floored at 1e-5: over all ``T`` frames
    without ``valid_frames``; else over each row's first ``valid_frames``
    frames only, and the frames past them are set to 0.  In the audio's
    dtype (float64 audio gives a float64 reference)."""
    need = (n_frames_total - 1) * hop + win
    if audio.shape[-1] < need:
        raise ValueError(f"{n_frames_total} frames need {need} samples, got {audio.shape[-1]}")
    dev = audio.device
    n_fft = int(2 ** np.ceil(np.log2(win)))
    frames = audio[:, :need].unfold(-1, win, hop) * torch.from_numpy(_hann(win)).to(dev, audio.dtype)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, 20.0, sample_rate / 2)).to(dev, audio.dtype)
    mel = torch.log(torch.clamp_min(power @ fb, 1e-10))
    if valid_frames is None:
        mean = mel.mean(dim=1, keepdim=True)
        std = mel.std(dim=1, keepdim=True, correction=0)
        return (mel - mean) / torch.clamp_min(std, 1e-5)
    mask = (torch.arange(n_frames_total, device=dev)[None, :] < valid_frames.to(dev)[:, None])
    m = mask[..., None].to(mel.dtype)
    denom = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
    mean = (mel * m).sum(dim=1, keepdim=True) / denom
    var = ((mel - mean).square() * m).sum(dim=1, keepdim=True) / denom
    mel = (mel - mean) / torch.clamp_min(var.sqrt(), 1e-5)
    return mel * m


def token_f1(hyp, ref) -> float:
    """Bag-of-tokens F1 (the 'nontrivially accurate text' metric)."""
    h, r = Counter(list(map(int, hyp))), Counter(list(map(int, ref)))
    overlap = sum((h & r).values())
    if overlap == 0:
        return 0.0
    prec = overlap / max(sum(h.values()), 1)
    rec = overlap / max(sum(r.values()), 1)
    return 2 * prec * rec / (prec + rec)


T2U_UPSAMPLE = 8  # the T2U encoder's three stride-2 transposed convs


def ctc_min_frames(labels) -> int:
    """The fewest frames a CTC alignment of ``labels`` needs: one a label,
    plus a blank between each pair of equal neighbours."""
    labels = np.asarray(labels)
    return int(len(labels) + np.count_nonzero(labels[1:] == labels[:-1]))


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor) -> torch.Tensor:
    """``optax.ctc_loss(logits, logit_paddings, labels, label_paddings)``:
    the per-row negative log-likelihood ``[B]`` (fp32) of ``labels [B, L]``
    (blank 0) under ``logits [B, T, C]``, each padding ``[B, ·]`` 1.0 on a
    right-padded tail.  Equal to optax on a row whose labels fit its frames
    (:func:`ctc_min_frames`); on one that does not it is inf where optax is
    about 1e5.  The log-softmax and the recursion run in float64: in fp32
    (as optax runs them) the gradient of a loss of 1e4, a random model's
    over 3,200 frames, is off by 3% of its peak, in optax as in
    ``F.ctc_loss``."""
    logp = torch.log_softmax(logits.double(), dim=-1).transpose(0, 1)
    in_len = (1.0 - logit_paddings).sum(1).round().long()
    tgt_len = (1.0 - label_paddings).sum(1).round().long()
    return F.ctc_loss(logp, labels.long(), in_len, tgt_len, blank=BLANK, reduction="none",
                      zero_infinity=False).float()


def build_s2st_bank(cfg: S2STTaskConfig, *, idx_offset: int = 0) -> dict:
    """Render the paired dataset into fixed-shape numpy arrays.

    Utterances longer than ``max_seconds`` or with over-long token
    sequences are re-drawn (next idx) so every row fits the static shapes.
    Returns arrays: audio [N, S], n_frames [N], src/src_pad [N, Ls],
    tgt/tgt_pad [N, Lt], dec_in/dec_out/dec_pad [N, Lt+1], units/units_pad
    [N, Lt], speaker [N].  Raises if a row's labels do not fit one of its
    four CTC losses' frames (:func:`ctc_loss`)."""
    corpus = FormantSpeechCorpus(n_speakers=cfg.n_speakers)
    N = cfg.n_utterances
    audio = np.zeros((N, cfg.n_samples), np.float32)
    n_frames = np.zeros(N, np.int32)
    Ls, Lt = cfg.max_src_tokens, cfg.max_tgt_tokens
    src = np.zeros((N, Ls), np.int32)
    src_pad = np.ones((N, Ls), np.float32)
    tgt = np.zeros((N, Lt), np.int32)
    tgt_pad = np.ones((N, Lt), np.float32)
    dec_in = np.zeros((N, Lt + 1), np.int32)
    dec_out = np.zeros((N, Lt + 1), np.int32)
    dec_pad = np.ones((N, Lt + 1), np.float32)
    units = np.zeros((N, Lt), np.int32)
    units_pad = np.ones((N, Lt), np.float32)
    speaker = np.zeros(N, np.int32)

    i = 0
    draw = 0
    while i < N:
        spk = i % cfg.n_speakers
        wav, plan, _ar = corpus.utterance(spk, idx_offset + draw, return_plan=True)
        draw += 1
        ids = plan_phone_ids(plan)
        s_toks = source_tokens(ids)
        t_toks = translate(ids)
        if len(wav) > cfg.n_samples or len(s_toks) > Ls or len(t_toks) > Lt or len(s_toks) == 0:
            continue
        audio[i, : len(wav)] = wav
        n_frames[i] = max(1, min((len(wav) - cfg.win) // cfg.hop + 1, cfg.n_frames))
        src[i, : len(s_toks)] = s_toks
        src_pad[i, : len(s_toks)] = 0.0
        tgt[i, : len(t_toks)] = t_toks
        tgt_pad[i, : len(t_toks)] = 0.0
        dec_in[i, 0] = BOS
        dec_in[i, 1 : len(t_toks) + 1] = t_toks
        dec_out[i, : len(t_toks)] = t_toks
        dec_out[i, len(t_toks)] = EOS
        dec_pad[i, : len(t_toks) + 1] = 0.0
        u = target_units(ids)
        units[i, : len(u)] = u
        units_pad[i, : len(u)] = 0.0
        speaker[i] = spk
        nf = int(n_frames[i])
        for name, labels, frames in (("source", s_toks, nf), ("target", t_toks, nf),
                                     ("unit", u, T2U_UPSAMPLE * nf),
                                     ("decoder unit", u, T2U_UPSAMPLE * (len(t_toks) + 1))):
            if ctc_min_frames(labels) > frames:
                raise ValueError(f"row {i} (draw {idx_offset + draw - 1}): its {name} CTC labels need "
                                 f"{ctc_min_frames(labels)} frames, it has {frames}")
        i += 1
    return dict(audio=audio, n_frames=n_frames, src=src, src_pad=src_pad, tgt=tgt, tgt_pad=tgt_pad,
                dec_in=dec_in, dec_out=dec_out, dec_pad=dec_pad, units=units, units_pad=units_pad,
                speaker=speaker)


S2ST_DECAY_STEPS = 200_000
ADAMW_BETAS, ADAMW_WEIGHT_DECAY, S2ST_GRAD_CLIP = (0.9, 0.999), 1e-4, 1.0  # optax.adamw's defaults


def s2st_learning_rate(cfg: S2STTaskConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, 200_000,
    lr · 0.05)`` at update ``count``."""
    return warmup_cosine_decay(count, 0.0, cfg.learning_rate, cfg.warmup_steps, S2ST_DECAY_STEPS,
                               cfg.learning_rate * 0.05)


@dataclass
class S2STTrainState:
    """The S2ST model (the trainer's tree: the transition head, no
    vocoder), its optimiser and the step; ``state_dict`` is what a
    checkpoint holds."""

    model: StreamSpeechS2ST
    opt: ScheduledAdam = field(repr=False)
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])


def create_s2st_state(
    model_cfg: StreamSpeechConfig,
    task_cfg: S2STTaskConfig = S2STTaskConfig(),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> S2STTrainState:
    """``StreamSpeechS2ST(model_cfg, with_vocoder=False)`` with its
    transition head (JAX's init tree), weights drawn from ``seed``, on
    ``device``, computing in ``dtype``; a fresh optimiser, optax's
    ``chain(clip_by_global_norm(1.0), adamw(schedule))``: clipping at a
    global norm of 1, AdamW (β 0.9, 0.999, eps 1e-8, decoupled weight decay
    1e-4 on every parameter) under :func:`s2st_learning_rate`."""
    device = resolve_device(device)
    model = StreamSpeechS2ST(model_cfg, dtype, gen=torch.Generator().manual_seed(seed), with_vocoder=False,
                             with_transition_head=True).to(device)
    opt = ScheduledAdam(model.parameters(), lambda count: s2st_learning_rate(task_cfg, count), betas=ADAMW_BETAS,
                        weight_decay=ADAMW_WEIGHT_DECAY, grad_clip=S2ST_GRAD_CLIP)
    return S2STTrainState(model, opt)


def make_s2st_sampler(cfg: S2STTaskConfig, n_rows: int) -> Callable[[torch.Generator], dict]:
    """``sample(gen) → {"idx", "use_prefix", "frac"}`` on ``gen``'s device:
    ``batch_size`` uniform rows of ``n_rows``, ``use_prefix ~
    Bernoulli(prefix_mask_prob)`` and ``frac ~ U(prefix_min_frac, 1)``."""
    B = cfg.batch_size

    def sample(gen: torch.Generator) -> dict:
        dev = gen.device
        idx = torch.randint(0, n_rows, (B,), generator=gen, device=dev)
        use_prefix = torch.rand(B, generator=gen, device=dev) < cfg.prefix_mask_prob
        frac = cfg.prefix_min_frac + (1.0 - cfg.prefix_min_frac) * torch.rand(B, generator=gen, device=dev)
        return {"idx": idx, "use_prefix": use_prefix, "frac": frac}

    return sample


def make_s2st_train_step(
    task_cfg: S2STTaskConfig,
    bank: dict,
    *,
    multi_steps: int = 1,
) -> Callable[..., tuple[S2STTrainState, dict]]:
    """``step(state, batch, bank=None) → (state, metrics)``; ``state`` (from
    :func:`create_s2st_state`) is updated in place and returned.  ``bank``:
    :func:`build_s2st_bank`'s arrays as tensors on the model's device (a
    call may pass another).

    ``batch`` is a ``torch.Generator`` on the bank's device, from which
    :func:`make_s2st_sampler` draws, or drawn ``{"idx" [B], "use_prefix"
    [B], "frac" [B]}``.  One step gathers the rows, computes their fbank
    (:func:`batched_fbank` over each row's valid frames) and restricts the
    decoder's cross attention on the ``use_prefix`` rows to the first
    ``max(int(frac · n_frames), 1)`` frames; the loss is ``src_ctc +
    tgt_ctc + dec_ce + 0.5·unit_ctc + 0.2·unit_dec_ctc +
    0.2·transition_bce`` (see the module docstring), one AdamW update.

    Metrics (0-dim fp32 tensors): ``loss``, ``src_ctc``, ``tgt_ctc``,
    ``dec_ce``, ``unit_ctc``, ``unit_dec_ctc``, ``transition_bce``,
    ``transition_acc`` (balanced: 0.5 for a constant head) and
    ``dec_acc``.  ``multi_steps > 1``: ``batch`` is a generator (each step
    draws its own) or a list of ``multi_steps`` draws; the metrics are the
    window's means."""
    T = task_cfg.n_frames
    default_bank = bank
    sample = make_s2st_sampler(task_cfg, bank["n_frames"].shape[0])
    del bank

    def loss_fn(model, bank, draw):
        dev = bank["audio"].device
        idx = torch.as_tensor(draw["idx"], device=dev).long()
        use_prefix = torch.as_tensor(draw["use_prefix"], device=dev).bool()
        frac = torch.as_tensor(draw["frac"], device=dev).float()
        nf = bank["n_frames"][idx].long()
        feats = batched_fbank(bank["audio"][idx], T, task_cfg.hop, task_cfg.win, valid_frames=nf)
        frames = torch.arange(T, device=dev)
        logit_pad = (frames[None, :] >= nf[:, None]).float()
        dec_in, dec_out, dec_pad = bank["dec_in"][idx].long(), bank["dec_out"][idx].long(), bank["dec_pad"][idx]
        cutoff = torch.where(use_prefix, (frac * nf.float()).int().clamp_min(1), torch.full_like(nf, T).int())
        cross_mask = frames[None, None, None, :] < cutoff[:, None, None, None]
        out = model(feats, dec_in, chunked=True, cross_mask=cross_mask, run_vocoder=False, decoder_units_out=True)
        units, units_pad = bank["units"][idx], bank["units_pad"][idx]
        l_src = ctc_loss(out["source_ctc_logits"], logit_pad, bank["src"][idx], bank["src_pad"][idx]).mean()
        l_tgt = ctc_loss(out["target_ctc_logits"], logit_pad, bank["tgt"][idx], bank["tgt_pad"][idx]).mean()
        unit_logits = out["unit_logits"]
        unit_pad = logit_pad.repeat_interleave(unit_logits.shape[1] // T, dim=1)
        l_unit = ctc_loss(unit_logits, unit_pad, units, units_pad).mean()
        logp = torch.log_softmax(out["text_logits"].float(), dim=-1)
        nll = -logp.gather(-1, dec_out[..., None])[..., 0]
        keep = 1.0 - dec_pad
        n_keep = keep.sum().clamp_min(1.0)
        l_dec = (nll * keep).sum() / n_keep
        correct = (logp.argmax(-1) == dec_out).float()
        acc = (correct * keep).sum() / n_keep
        du_logits = out["decoder_unit_logits"]
        du_pad = dec_pad.repeat_interleave(du_logits.shape[1] // dec_pad.shape[1], dim=1)
        l_unit_dec = ctc_loss(du_logits, du_pad, units, units_pad).mean()
        # the learned READ/WRITE head: is the decoder already right under
        # this read prefix?  Scored on prefix-masked rows only, class-balanced
        # (positives and negatives each carry half the weight)
        wl = out["write_logits"]
        tkeep = keep * use_prefix[:, None].float()
        pos, neg = (correct * tkeep).sum(), ((1.0 - correct) * tkeep).sum()
        weight = torch.where(correct > 0.5, 0.5 / pos.clamp_min(1.0), 0.5 / neg.clamp_min(1.0)) * tkeep
        l_trans = (F.binary_cross_entropy_with_logits(wl, correct, reduction="none") * weight).sum()
        pred_w = (wl > 0).float()
        tpr = (pred_w * correct * tkeep).sum() / pos.clamp_min(1.0)
        tnr = ((1.0 - pred_w) * (1.0 - correct) * tkeep).sum() / neg.clamp_min(1.0)
        total = l_src + l_tgt + l_dec + 0.5 * l_unit + 0.2 * l_unit_dec + 0.2 * l_trans
        return total, {"src_ctc": l_src, "tgt_ctc": l_tgt, "dec_ce": l_dec, "unit_ctc": l_unit,
                       "unit_dec_ctc": l_unit_dec, "transition_bce": l_trans, "transition_acc": 0.5 * (tpr + tnr),
                       "dec_acc": acc}

    def one_step(state: S2STTrainState, batch, bank) -> dict:
        bank = default_bank if bank is None else bank
        if isinstance(batch, torch.Generator):
            batch = sample(batch)
        loss, aux = loss_fn(state.model, bank, batch)
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def step(state: S2STTrainState, batch, bank: dict | None = None) -> tuple[S2STTrainState, dict]:
        return state, one_step(state, batch, bank)

    return fuse_steps(step, multi_steps)


def make_greedy_translate(model: StreamSpeechS2ST, task_cfg: S2STTaskConfig, max_len: int = 56
                          ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``run(audio [B, S], n_frames [B]) → tokens [B, max_len]``: offline
    greedy decoding, as the JAX package decodes: encode once (chunked),
    then at each of ``max_len`` steps the whole text decoder over the token
    buffer, the argmax of position ``t`` written to ``t + 1``; everything
    from the first EOS on is zeroed."""

    @torch.no_grad()
    def run(audio: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        dev = next(model.parameters()).device
        audio, n_frames = torch.as_tensor(audio, device=dev), torch.as_tensor(n_frames, device=dev)
        feats = batched_fbank(audio, task_cfg.n_frames, task_cfg.hop, task_cfg.win, valid_frames=n_frames)
        enc = model.encoder(feats, chunked=True)
        dec = torch.zeros((audio.shape[0], max_len + 1), dtype=torch.long, device=dev)
        dec[:, 0] = BOS
        for t in range(max_len):
            dec[:, t + 1] = model.text_decoder(enc, dec)[:, t].argmax(-1)
        toks = dec[:, 1:]
        return torch.where((toks == EOS).long().cumsum(1) > 0, torch.zeros_like(toks), toks)

    return run


def evaluate_token_f1(model: StreamSpeechS2ST, task_cfg: S2STTaskConfig, bank: dict, *, batch_size: int = 8,
                      ) -> dict:
    """Greedy-decode a held-out bank (numpy arrays of
    :func:`build_s2st_bank`) in batches of ``batch_size`` (a last partial
    batch is dropped, as in JAX) and report the mean bag-of-tokens F1, the
    exact-sequence rate and the count: ``{"token_f1", "exact_match", "n"}``."""
    run = make_greedy_translate(model, task_cfg, max_len=bank["tgt"].shape[1])
    N = bank["audio"].shape[0]
    f1s, exact = [], 0
    for i in range(0, N - N % batch_size, batch_size):
        sl = slice(i, i + batch_size)
        toks = run(torch.from_numpy(bank["audio"][sl]), torch.from_numpy(bank["n_frames"][sl])).cpu().numpy()
        for b in range(toks.shape[0]):
            ref = bank["tgt"][i + b][bank["tgt_pad"][i + b] == 0]
            hyp = toks[b][toks[b] != 0]
            f1s.append(token_f1(hyp, ref))
            exact += int(len(hyp) == len(ref) and (hyp == ref).all())
    n = len(f1s)
    return {"token_f1": float(np.mean(f1s)) if f1s else 0.0, "exact_match": exact / max(n, 1), "n": n}
