"""Voice-cloning evaluation: does the conditioning pathway work?

Counterpart of ``hifigan_tpu/eval/cloning_eval.py``, three demonstrations:

1. **Encoder separation**: with trained encoders, same-speaker cosine
   similarity must exceed cross-speaker similarity by a wide margin.
2. **Cross-speaker transfer**: content of speaker A + a reference clip of
   speaker B → the output must verify as B (cosine to B's centroid ≥ 0.7
   and closer to B than to A).  The parallel corpus gives B's own
   rendition of the content, so transfer fidelity is also measured as
   mel-L1 against it.
3. **Conditioning ablation**: a zero or wrong-speaker reference in place of
   the right one must lower the similarity to the own speaker.

The functions take ``mel_fn``/``audio_mel_fn`` that accept host tensors and
put them on their device, and device functions for synthesis and embedding;
the cosines and centroids are computed on the host in fp32, as JAX does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from hifigan_tpu_torch.train.cloning import CONTENT_KEY_BASE, REF_KEY_BASE
from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus

# held-out content keys: disjoint from the training banks' keys
EVAL_CONTENT_BASE = CONTENT_KEY_BASE + 500_000
EVAL_REF_BASE = REF_KEY_BASE + 500_000

VERIFY_THRESHOLD = 0.7


def _pad(audio: np.ndarray, n: int) -> torch.Tensor:
    """``[1, n]``: ``audio`` cut or zero-padded to ``n`` samples."""
    out = np.zeros(n, np.float32)
    out[: min(n, len(audio))] = audio[:n]
    return torch.from_numpy(out[None])


def _embedding(embed_fn: Callable, mel) -> np.ndarray:
    return embed_fn(mel)[0].detach().cpu().numpy()


def _unit(emb: np.ndarray) -> np.ndarray:
    return emb / max(np.linalg.norm(emb), 1e-9)


def speaker_centroids(embed_fn: Callable, mel_fn: Callable, corpus: FormantSpeechCorpus, *, n_speakers: int,
                      clips_per_speaker: int = 4, segment_samples: int = 32_768,
                      key_base: int = EVAL_REF_BASE + 100_000) -> np.ndarray:
    """Per-speaker mean embedding over held-out clips → ``[S, D]``
    (L2-normalised)."""
    cents = []
    for s in range(n_speakers):
        embs = []
        for j in range(clips_per_speaker):
            wav = corpus.utterance(s, 0, content=key_base + j)
            embs.append(_embedding(embed_fn, mel_fn(_pad(wav, segment_samples))))
        cents.append(_unit(np.mean(embs, axis=0)))
    return np.stack(cents)


def encoder_separation(embed_fn: Callable, mel_fn: Callable, corpus: FormantSpeechCorpus, *, n_speakers: int = 8,
                       clips_per_speaker: int = 4, segment_samples: int = 32_768) -> Dict[str, float]:
    """Same-speaker vs cross-speaker cosine statistics on held-out clips,
    and the verification accuracy at 0.7.  A discriminative encoder has
    ``same_mean − cross_mean`` well above zero."""
    embs = []
    for s in range(n_speakers):
        for j in range(clips_per_speaker):
            wav = corpus.utterance(s, 0, content=EVAL_REF_BASE + 7_000 + s * 101 + j)
            embs.append((s, _embedding(embed_fn, mel_fn(_pad(wav, segment_samples)))))
    same, cross = [], []
    for i in range(len(embs)):
        for j in range(i + 1, len(embs)):
            sim = float(np.dot(embs[i][1], embs[j][1])
                        / max(np.linalg.norm(embs[i][1]) * np.linalg.norm(embs[j][1]), 1e-9))
            (same if embs[i][0] == embs[j][0] else cross).append(sim)
    same, cross = np.array(same), np.array(cross)
    acc = (np.concatenate([(same >= VERIFY_THRESHOLD), (cross < VERIFY_THRESHOLD)]).mean()
           if len(same) and len(cross) else 0.0)
    return {
        "same_speaker_mean": float(same.mean()),
        "same_speaker_std": float(same.std()),
        "cross_speaker_mean": float(cross.mean()),
        "cross_speaker_std": float(cross.std()),
        "separation": float(same.mean() - cross.mean()),
        "verification_accuracy_at_0.7": float(acc),
    }


def evaluate_cloning_transfer(
    synthesize_fn: Callable,  # (content_mel, ref_mel) -> wav [1, 1, T]
    embed_fn: Callable,       # mel -> [1, D] (the trained speaker encoder)
    mel_fn: Callable,         # wav [1, T] -> mel [1, n_mels, T']
    audio_mel_fn: Callable,   # host audio [1, S] -> mel (the same transform)
    corpus: FormantSpeechCorpus,
    *,
    n_speakers: int = 8,
    n_contents: int = 4,
    segment_samples: int = 32_768,
    ref_samples: int = 16_384,
    centroids: Optional[np.ndarray] = None,
) -> Dict:
    """Cross-speaker transfer grid and conditioning ablation.

    For every (content c, source speaker A, target speaker B ≠ A):
    synthesise A's content mel conditioned on B's reference clip, then
    check that the output (i) verifies as B, (ii) is closer to B than to
    A, and (iii) how far it lies in mel-L1 from B's parallel rendition and
    from A's.  Then, per (c, A), the ablation: A's content with A's own
    reference, with a zero reference and with a wrong speaker's (drawn
    from a generator seeded 0), each scored against A's centroid."""
    if centroids is None:
        centroids = speaker_centroids(embed_fn, audio_mel_fn, corpus, n_speakers=n_speakers,
                                      segment_samples=segment_samples)
    rows = []
    abl_correct, abl_zero, abl_shuffle = [], [], []
    mel_to_target, mel_to_source = [], []
    rng = np.random.default_rng(0)
    for ci in range(n_contents):
        ck = EVAL_CONTENT_BASE + ci
        ar = corpus.content_arousal(ck)
        renditions = {s: _pad(corpus.utterance(s, 0, content=ck), segment_samples) for s in range(n_speakers)}
        refs = {s: _pad(corpus.utterance(s, 0, content=EVAL_REF_BASE + 31 * ci + s, arousal=ar), ref_samples)
                for s in range(n_speakers)}
        for a in range(n_speakers):
            content_mel = audio_mel_fn(renditions[a])
            tgt_mels = {}
            for b in range(n_speakers):
                if a == b:
                    continue
                wav = synthesize_fn(content_mel, audio_mel_fn(refs[b]))
                gen_mel = mel_fn(wav[:, 0, :])
                emb = _unit(_embedding(embed_fn, gen_mel))
                sim_b = float(np.dot(emb, centroids[b]))
                sim_a = float(np.dot(emb, centroids[a]))
                if b not in tgt_mels:
                    tgt_mels[b] = audio_mel_fn(renditions[b])
                frames = min(gen_mel.shape[-1], tgt_mels[b].shape[-1], content_mel.shape[-1])
                l1_tgt = float(torch.mean(torch.abs(gen_mel[..., :frames] - tgt_mels[b][..., :frames])))
                l1_src = float(torch.mean(torch.abs(gen_mel[..., :frames] - content_mel[..., :frames])))
                rows.append({
                    "content": ci, "source": a, "target": b,
                    "sim_target": sim_b, "sim_source": sim_a,
                    "verified_as_target": bool(sim_b >= VERIFY_THRESHOLD and sim_b > sim_a),
                    "mel_l1_to_target_rendition": l1_tgt,
                    "mel_l1_to_source_rendition": l1_src,
                })
                mel_to_target.append(l1_tgt)
                mel_to_source.append(l1_src)

            # the ablation on the identity pair (A's content with A's reference)
            ref_mel_own = audio_mel_fn(refs[a])
            wav_c = synthesize_fn(content_mel, ref_mel_own)
            abl_correct.append(float(np.dot(_unit(_embedding(embed_fn, mel_fn(wav_c[:, 0, :]))), centroids[a])))
            wav_z = synthesize_fn(content_mel, torch.zeros_like(ref_mel_own))
            abl_zero.append(float(np.dot(_unit(_embedding(embed_fn, mel_fn(wav_z[:, 0, :]))), centroids[a])))
            wrong = int(rng.choice([s for s in range(n_speakers) if s != a]))
            wav_s = synthesize_fn(content_mel, audio_mel_fn(refs[wrong]))
            abl_shuffle.append(float(np.dot(_unit(_embedding(embed_fn, mel_fn(wav_s[:, 0, :]))), centroids[a])))

    n = len(rows)
    verified = sum(r["verified_as_target"] for r in rows)
    closer = sum(r["sim_target"] > r["sim_source"] for r in rows)
    return {
        "n_transfer_pairs": n,
        "transfer_verified_rate": verified / max(n, 1),
        "transfer_closer_to_target_rate": closer / max(n, 1),
        "transfer_sim_target_mean": float(np.mean([r["sim_target"] for r in rows])) if rows else 0.0,
        "transfer_sim_source_mean": float(np.mean([r["sim_source"] for r in rows])) if rows else 0.0,
        "mel_l1_to_target_rendition_mean": float(np.mean(mel_to_target)) if mel_to_target else 0.0,
        "mel_l1_to_source_rendition_mean": float(np.mean(mel_to_source)) if mel_to_source else 0.0,
        "ablation": {
            "correct_ref_sim_to_own": float(np.mean(abl_correct)),
            "zero_ref_sim_to_own": float(np.mean(abl_zero)),
            "wrong_ref_sim_to_own": float(np.mean(abl_shuffle)),
        },
        "pairs": rows,
    }
