"""Voice-cloning training: the FiLM conditioning made necessary.

Counterpart of ``hifigan_tpu/train/cloning.py``.  The vocoder learns

    input   = mel of (content c, speaker A)
    ref     = clip of speaker B (matched arousal)
    target  = waveform of (content c, speaker B)

on the formant corpus's parallel renditions (same phone plan, prosody and
timing; another vocal identity), so the generator can only match the
target by taking the identity from the reference through the extractor and
FiLM.  Both banks (content renditions ``[S, C, L]`` and arousal-matched
reference clips ``[S, C, L_ref]``) live in device memory, and each step's
pairs are drawn there with a ``torch.Generator`` (JAX draws them with its
PRNG inside the jitted step); a step also takes an explicit batch, so that
the tests feed it the pairs JAX drew.

The step is the GAN step of :mod:`hifigan_tpu_torch.train.train_step` (the
discriminator update before the generator's loss, the plain GRC chain
differentiated), conditioned through ``reference_mel``, with an optional
identity term from a frozen judge ECAPA-TDNN and an optional
conditioning-only fine-tune.  :class:`CloningProbe` is the trainer's
eval-protocol probe: held-out transfer pairs through the kernel path.
"""

from __future__ import annotations

import hashlib
import inspect
import logging
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step, grc_step_reference
from hifigan_tpu_torch.train import corpus as _corpus_mod
from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus
from hifigan_tpu_torch.train.state import GanTrainState, TrainConfig
from hifigan_tpu_torch.train.train_step import audio_to_mel, discriminator_phase, generator_losses

log = logging.getLogger(__name__)

# content keys disjoint from every legacy draw (legacy keys are
# speaker * 1_000_003 + idx with small idx; eval clips use 10_000+)
CONTENT_KEY_BASE = 50_000_000
REF_KEY_BASE = 60_000_000
# The port's bank cache: its own name beside the JAX package's
# cloning_bank.npz, whose key hashes the JAX corpus module (each package's
# key would reject the other's file and overwrite it).
CACHE_NAME = "cloning_bank_torch.npz"


def default_cache_path() -> str:
    """``$HIFIGAN_TPU_CACHE/cloning_bank_torch.npz`` (the directory defaults
    to ``hifigan_tpu_cache`` in the temporary directory)."""
    root = os.environ.get("HIFIGAN_TPU_CACHE", os.path.join(tempfile.gettempdir(), "hifigan_tpu_cache"))
    return os.path.join(root, CACHE_NAME)


def _corpus_rev() -> int:
    """A fingerprint of the corpus renderer: a hash of the port's corpus
    module's source, so any change to the renderer invalidates cached banks."""
    src = inspect.getsource(_corpus_mod).encode()
    return int.from_bytes(hashlib.sha256(src).digest()[:6], "big")


def build_cloning_banks(
    *,
    n_speakers: int = 32,
    n_contents: int = 32,
    pad_to_multiple: int = 128,
    cache_path: Optional[str] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The parallel corpus: ``(content_bank [S, C, L], ref_bank [S, C,
    L_ref], lengths [C])``, lengths per content (the same for every
    speaker by construction).  ``ref_bank[s, c]`` is an other-content clip
    of speaker ``s`` rendered at content ``c``'s arousal.  A cache file
    whose key (corpus revision, key bases, grid) differs is re-rendered."""
    cache_key = np.array([_corpus_rev(), CONTENT_KEY_BASE, REF_KEY_BASE, n_speakers, n_contents, pad_to_multiple],
                         np.int64)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        if "cache_key" in z and np.array_equal(z["cache_key"], cache_key):
            return z["content_bank"], z["ref_bank"], z["lengths"]
        log.warning("cloning bank cache %s is stale (key mismatch): re-rendering", cache_path)
    corpus = FormantSpeechCorpus(n_speakers=n_speakers)
    contents = [CONTENT_KEY_BASE + j for j in range(n_contents)]
    utts: list[list[np.ndarray]] = []
    refs: list[list[np.ndarray]] = []
    for s in range(n_speakers):
        row, ref_row = [], []
        for j, ck in enumerate(contents):
            row.append(corpus.utterance(s, 0, content=ck))
            ar = corpus.content_arousal(ck)
            ref_row.append(corpus.utterance(s, 0, content=REF_KEY_BASE + (j * 7 + s) % (4 * n_contents),
                                            arousal=ar))
        utts.append(row)
        refs.append(ref_row)

    def pack(rows):
        L = max(len(u) for row in rows for u in row)
        L = -(-L // pad_to_multiple) * pad_to_multiple
        bank = np.zeros((len(rows), len(rows[0]), L), np.float32)
        for s, row in enumerate(rows):
            for c, u in enumerate(row):
                bank[s, c, : len(u)] = u
        return bank

    content_bank, ref_bank = pack(utts), pack(refs)
    lengths = np.array([len(utts[0][c]) for c in range(n_contents)], np.int32)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez(cache_path, content_bank=content_bank, ref_bank=ref_bank, lengths=lengths, cache_key=cache_key)
    return content_bank, ref_bank, lengths


def make_pair_sampler(
    lengths: torch.Tensor,
    segment_samples: int,
    ref_samples: int,
    batch_size: int,
) -> Callable[[torch.Generator, torch.Tensor, torch.Tensor], dict]:
    """``sample(gen, content_bank, ref_bank) → {"input", "target", "ref",
    "tgt_spk"}``: ``input`` and ``target`` are the same (content, offset)
    crop rendered by speakers A and B, ``ref`` a crop of B's
    arousal-matched reference clip.  JAX's rules: the offset is uniform
    over ``max(length − segment, 1)``, the reference's over ``max(L_ref −
    ref_samples, 1)`` of the bank's width.  ``lengths [C]`` and ``gen`` are
    on the banks' device."""
    seg, rseg = segment_samples, ref_samples
    lengths = lengths.long()

    def sample(gen: torch.Generator, content_bank: torch.Tensor, ref_bank: torch.Tensor) -> dict:
        S, C, L = content_bank.shape
        if L < seg or ref_bank.shape[-1] < rseg:
            raise ValueError(f"the banks' rows ({L}, {ref_bank.shape[-1]} samples) are shorter than a crop "
                             f"({seg}, {rseg})")
        dev = content_bank.device
        c = torch.randint(0, C, (batch_size,), generator=gen, device=dev)
        a = torch.randint(0, S, (batch_size,), generator=gen, device=dev)
        b = torch.randint(0, S, (batch_size,), generator=gen, device=dev)
        span = (lengths[c] - seg).clamp_min(1)
        off = (torch.rand(batch_size, generator=gen, device=dev) * span).long()
        rspan = max(ref_bank.shape[-1] - rseg, 1)
        roff = (torch.rand(batch_size, generator=gen, device=dev) * rspan).long()
        idx = off[:, None] + torch.arange(seg, device=dev)
        ridx = roff[:, None] + torch.arange(rseg, device=dev)
        return {"input": content_bank[a[:, None], c[:, None], idx],
                "target": content_bank[b[:, None], c[:, None], idx],
                "ref": ref_bank[b[:, None], c[:, None], ridx], "tgt_spk": b}

    return sample


def is_conditioning(name: str) -> bool:
    """Whether a vocoder parameter belongs to the conditioning pathway (the
    extractor and every FiLM layer), JAX's ``_is_conditioning``."""
    return "embedding_extractor" in name or "film_" in name


def make_cloning_train_step(
    cfg: TrainConfig,
    sample_fn: Optional[Callable] = None,
    *,
    deep_feature_matching: bool = True,
    multi_steps: int = 1,
    identity_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    identity_weight: float = 0.0,
    identity_centroids: Optional[torch.Tensor] = None,
    identity_margin: float = 0.8,
    identity_finetune: bool = False,
) -> Callable[..., tuple[GanTrainState, dict]]:
    """``step(state, batch, content_bank=None, ref_bank=None) → (state,
    metrics)``, ``state`` updated in place.

    ``batch``: a ``torch.Generator`` on the banks' device, with which
    ``sample_fn`` (:func:`make_pair_sampler`) draws each step's pairs from
    the banks, or drawn pairs ``{"input", "target", "ref", "tgt_spk"}``
    (with a leading ``[multi_steps]`` axis when ``multi_steps > 1``).

    The generator synthesises the input's mel conditioned through
    ``reference_mel`` (the plain GRC chain: the CUDA kernel has no
    backward) and is held to the target rendition: the discriminators'
    update first, then the generator's losses against the updated
    discriminators.  ``identity_fn`` (a frozen judge: its parameters take
    no gradient and enter no optimiser) with ``identity_weight > 0`` adds
    ``identity_weight`` times, on the generated mel, either the centroid
    hinge ``mean(relu(margin − cos(e_fake/‖e_fake‖, centroid[tgt]))²)``
    (with ``identity_centroids [S, D]``) or the rendition cosine ``1 −
    cos(e_fake, e_tgt)`` with ``e_tgt`` of the target's mel, no gradient;
    the metrics gain ``identity_loss`` and ``identity_cos``.
    ``identity_finetune``: the generator's gradients outside the
    conditioning pathway (:func:`is_conditioning`) are zeros, so Adam
    decays their moments as optax does, and after the update every such
    parameter is put back as it was.  The discriminators still train."""
    w = cfg.loss_weights
    hop = cfg.mel.hop_length
    use_identity = identity_fn is not None and identity_weight > 0

    def one_step(state: GanTrainState, batch: dict) -> dict:
        voc, discs = state.vocoder, state.discriminators
        dev = state.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        content_mel = audio_to_mel(batch["input"], cfg)
        ref_mel = audio_to_mel(batch["ref"], cfg)
        real = batch["target"][:, : content_mel.shape[-1] * hop]
        target_mel = audio_to_mel(real, cfg)
        fake = voc(content_mel, reference_mel=ref_mel, step=grc_step_reference)["waveform"][:, 0, :]

        d_loss = discriminator_phase(state, real, fake, w)
        gen_mel = audio_to_mel(fake, cfg)
        total, metrics = generator_losses(discs, real, fake, gen_mel, target_mel, w, deep_feature_matching)
        if use_identity:
            e_fake = identity_fn(gen_mel)
            if identity_centroids is not None:
                e_n = e_fake / e_fake.norm(dim=-1, keepdim=True).clamp_min(1e-8)
                cos = (e_n * identity_centroids[batch["tgt_spk"].long()]).sum(-1)
                id_loss = F.relu(identity_margin - cos).square().mean()
            else:
                with torch.no_grad():
                    e_tgt = identity_fn(target_mel)
                cos = (e_fake * e_tgt).sum(-1) / (e_fake.norm(dim=-1) * e_tgt.norm(dim=-1)).clamp_min(1e-8)
                id_loss = (1.0 - cos).mean()
            total = total + identity_weight * id_loss
            metrics.update(identity_loss=id_loss, identity_cos=cos.mean())
        state.gen_opt.zero_grad()
        total.backward()
        frozen = [p for n, p in voc.named_parameters() if not is_conditioning(n)] if identity_finetune else []
        saved = [p.detach().clone() for p in frozen]
        for p in frozen:
            p.grad = torch.zeros_like(p)
        state.gen_opt.step()
        with torch.no_grad():
            for p, old in zip(frozen, saved):
                p.copy_(old)
        state.step += 1
        return {"generator_loss": total.detach(), "discriminator_loss": d_loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}}

    def batches(batch, content_bank, ref_bank) -> list[dict]:
        if isinstance(batch, torch.Generator):
            return [sample_fn(batch, content_bank, ref_bank) for _ in range(multi_steps)]
        if multi_steps == 1:
            return [batch]
        return [{k: v[i] for k, v in batch.items()} for i in range(multi_steps)]

    def step(state: GanTrainState, batch, content_bank=None, ref_bank=None) -> tuple[GanTrainState, dict]:
        window = [one_step(state, b) for b in batches(batch, content_bank, ref_bank)]
        if len(window) == 1:
            return state, window[0]
        return state, {k: torch.stack([m[k] for m in window]).mean() for k in window[0]}

    return step


class CloningProbe:
    """The trainer's eval-protocol probe (JAX ``cli train-clone``): 16 fixed
    held-out transfer pairs (content of speaker a, 32,768 samples; a
    reference of speaker b at the content's arousal, 16,384 samples) cloned
    by the vocoder on its default path (the GRC kernel on the card), judged
    by the frozen ECAPA-TDNN against per-speaker centroids of 32,768-sample
    clips.  ``probe(vocoder) → (mean target cosine, share verified)``: a
    pair verifies when its target cosine is at least 0.7 and above its
    source cosine.  ``centroids_seg`` are the centroids at the training
    crop length, the identity hinge's."""

    N_PAIRS = 16

    def __init__(self, judge: torch.nn.Module, cfg: TrainConfig, *, n_speakers: int, segment_samples: int,
                 device: torch.device):
        from hifigan_tpu_torch.eval.cloning_eval import EVAL_CONTENT_BASE, EVAL_REF_BASE, _pad, speaker_centroids

        self.judge, self.cfg = judge, cfg
        corpus = FormantSpeechCorpus(n_speakers=n_speakers)
        embed = torch.no_grad()(judge)
        mel_of = torch.no_grad()(lambda w: audio_to_mel(w.to(device), cfg))
        self.centroids_seg = torch.from_numpy(speaker_centroids(
            embed, mel_of, corpus, n_speakers=n_speakers, segment_samples=segment_samples)).to(device)
        self.centroids = torch.from_numpy(speaker_centroids(embed, mel_of, corpus, n_speakers=n_speakers)).to(device)
        pc, pr, tgt, src = [], [], [], []
        for i in range(self.N_PAIRS):
            a = i % 8
            b = (a + 1 + (i * 3) % 7) % 8
            ck = EVAL_CONTENT_BASE + (i % 4)
            ar = corpus.content_arousal(ck)
            pc.append(_pad(corpus.utterance(a, 0, content=ck), 32_768))
            pr.append(_pad(corpus.utterance(b, 0, content=EVAL_REF_BASE + 31 * (i % 4) + b, arousal=ar), 16_384))
            src.append(a)
            tgt.append(b)
        self.content_mel = mel_of(torch.cat(pc))
        self.ref_mel = mel_of(torch.cat(pr))
        self.tgt = torch.tensor(tgt, device=device)
        self.src = torch.tensor(src, device=device)

    @torch.no_grad()
    def waveform(self, vocoder, step=grc_step) -> torch.Tensor:
        """The 16 cloned waveforms ``[16, T]``."""
        return vocoder(self.content_mel, reference_mel=self.ref_mel, step=step)["waveform"][:, 0, :]

    @torch.no_grad()
    def __call__(self, vocoder) -> tuple[torch.Tensor, torch.Tensor]:
        e = self.judge(audio_to_mel(self.waveform(vocoder), self.cfg))
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        cos_t = (e * self.centroids[self.tgt]).sum(-1)
        cos_s = (e * self.centroids[self.src]).sum(-1)
        return cos_t.mean(), ((cos_t >= 0.7) & (cos_t > cos_s)).float().mean()
