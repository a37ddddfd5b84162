"""ASR-BLEU command line: transcribe a directory of generated waveforms
and score them against a reference manifest.

Counterpart of ``hifigan_tpu/eval/asr_bleu.py``: ``<i>_pred.wav`` files
are paired with reference lines by their index (sorted numerically),
optionally silence-trimmed, transcribed, and scored with corpus BLEU; the
transcripts can be written out (``--transcripts_path``).

    python -m hifigan_tpu_torch.eval.asr_bleu --lang en \\
        --audio_dirpath generated/ --reference_path refs.txt \\
        [--transcripts_path out.txt] [--results_dirpath results/] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import wave
from typing import List, Optional, Tuple

import numpy as np

from hifigan_tpu_torch.eval.metrics import corpus_bleu
from hifigan_tpu_torch.streaming.features import read_wav

__all__ = ["TEXT_POSTPROCESSORS", "compose_eval_data", "main", "postprocess_hokkien", "read_wav",
           "remove_silence", "run_asr_bleu", "write_wav"]


def postprocess_hokkien(text: str) -> str:
    """Tâi-lô romanisation normalisation for Hokkien ASR output:
    lower-case, split hyphenated syllables, strip tone digits."""
    text = text.lower().replace("-", " ")
    text = re.sub(r"(\d)", r" ", text)
    return re.sub(r"\s+", " ", text).strip()


TEXT_POSTPROCESSORS = {"hok": postprocess_hokkien}


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16_000) -> None:
    """Mono 16-bit PCM, the audio clipped to [-1, 1]."""
    audio = np.clip(np.asarray(audio, dtype=np.float32).reshape(-1), -1.0, 1.0)
    pcm = (audio * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def remove_silence(audio: np.ndarray, sample_rate: int = 16_000, frame_ms: int = 30,
                   threshold_db: float = -40.0) -> np.ndarray:
    """Energy-based silence removal: drop the ``frame_ms`` frames whose RMS
    is at most ``threshold_db`` (the tail shorter than a frame too); the
    audio unchanged if that would drop every frame."""
    frame = int(sample_rate * frame_ms / 1000)
    n = len(audio) // frame
    if n == 0:
        return audio
    frames = audio[: n * frame].reshape(n, frame)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    keep = db > threshold_db
    if not keep.any():
        return audio
    return frames[keep].reshape(-1)


def compose_eval_data(audio_dirpath: str, reference_path: str) -> List[Tuple[str, str]]:
    """``(path, reference line)`` of each ``<i>_pred.wav``, sorted by ``i``,
    for the ``i`` that have a reference line."""
    with open(reference_path) as f:
        refs = [line.strip() for line in f]
    pat = re.compile(r"^(\d+)_pred\.wav$")
    pairs = []
    for name in os.listdir(audio_dirpath):
        m = pat.match(name)
        if m:
            pairs.append((int(m.group(1)), os.path.join(audio_dirpath, name)))
    pairs.sort()
    return [(path, refs[i]) for i, path in pairs if i < len(refs)]


def run_asr_bleu(lang: str, audio_dirpath: str, reference_path: str, *, transcriber=None,
                 rm_silence: bool = False, transcripts_path: Optional[str] = None, device: str = "cuda") -> dict:
    """``{"bleu", "num_samples", "hypotheses", "references"}``; without a
    ``transcriber``, :func:`make_transcriber` for ``lang`` on ``device``."""
    if transcriber is None:
        from hifigan_tpu_torch.eval.asr import make_transcriber

        transcriber = make_transcriber(lang, device=device)
        if transcriber is None:
            raise RuntimeError(f"no ASR model reachable for lang={lang}; pass transcriber=")
    pairs = compose_eval_data(audio_dirpath, reference_path)
    post = TEXT_POSTPROCESSORS.get(lang, lambda t: t)
    hyps, refs = [], []
    for path, ref in pairs:
        audio, sr = read_wav(path)
        if rm_silence:
            audio = remove_silence(audio, sr)
        hyps.append(post(transcriber(audio)))
        refs.append(post(ref.strip().lower()))
    bleu = corpus_bleu(hyps, refs)
    if transcripts_path:
        with open(transcripts_path, "w") as f:
            f.write("\n".join(hyps))
    return {"bleu": bleu, "num_samples": len(pairs), "hypotheses": hyps, "references": refs}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lang", default="en")
    p.add_argument("--audio_dirpath", required=True)
    p.add_argument("--reference_path", required=True)
    p.add_argument("--rm_silence", action="store_true")
    p.add_argument("--transcripts_path", default=None)
    p.add_argument("--results_dirpath", default=None)
    p.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    args = p.parse_args(argv)
    result = run_asr_bleu(args.lang, args.audio_dirpath, args.reference_path, rm_silence=args.rm_silence,
                          transcripts_path=args.transcripts_path, device=args.device)
    print(json.dumps({"bleu": result["bleu"], "num_samples": result["num_samples"]}))
    if args.results_dirpath:
        os.makedirs(args.results_dirpath, exist_ok=True)
        with open(os.path.join(args.results_dirpath, f"asr_bleu_{args.lang}.json"), "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
