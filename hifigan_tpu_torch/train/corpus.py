"""Procedural formant-synthesis speech corpus.

The port's own copy of ``hifigan_tpu/train/corpus.py`` (numpy and
``scipy.signal``), bit for bit the same clips, phone plans and arousals for
the same ``(speaker, utterance)`` or ``content`` keys: every held-out
evaluation clip, reference transcript and character error rate downstream
comes from it.

A Klatt-style source–filter synthesiser: a glottal pulse train with
jitter/shimmer and aspiration noise drives a cascade of time-varying
formant resonators, with stop bursts, fricative noise and nasal murmurs
layered per phone.  The output has the acoustic structure a vocoder must
learn (harmonic voicing, formant transitions, unvoiced segments,
per-speaker vocal-tract scaling, per-utterance prosody).  Speakers are
parameterised by (f0 base, vocal-tract length factor, breathiness);
"emotion" is an arousal scalar modulating f0 range, rate and level.
Everything is deterministic per ``(speaker, utterance)`` index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy import signal as sps

SAMPLE_RATE = 16_000

# Vowel formant targets (Hz) — adult-male reference values; scaled per
# speaker by the vocal-tract factor.
_VOWELS = {
    "a": (730, 1090, 2440),
    "e": (530, 1840, 2480),
    "i": (270, 2290, 3010),
    "o": (570, 840, 2410),
    "u": (300, 870, 2240),
    "ae": (660, 1720, 2410),
    "uh": (640, 1190, 2390),
    "er": (490, 1350, 1690),
}
_VOWEL_KEYS = sorted(_VOWELS)

# Consonants: (kind, locus frequencies / noise band)
_CONSONANTS = {
    "s": ("fric", (5200, 1200)),
    "sh": ("fric", (2600, 900)),
    "f": ("fric", (4200, 2500)),
    "h": ("fric", (1200, 1500)),
    "z": ("vfric", (5200, 1200)),
    "p": ("stop", (800, 1200)),
    "t": ("stop", (3800, 1500)),
    "k": ("stop", (2200, 900)),
    "b": ("vstop", (800, 1200)),
    "d": ("vstop", (3400, 1500)),
    "g": ("vstop", (2000, 900)),
    "m": ("nasal", (250, 1100)),
    "n": ("nasal", (250, 1500)),
    "l": ("liquid", (360, 1300)),
    "r": ("liquid", (420, 1300)),
}
_CONS_KEYS = sorted(_CONSONANTS)


@dataclass(frozen=True)
class SpeakerProfile:
    """Per-speaker acoustic identity."""

    f0_base: float      # Hz
    tract_factor: float  # formant scale (vocal-tract length proxy)
    breathiness: float  # aspiration mix 0..1
    f0_range: float     # semitone span of accents

    @staticmethod
    def from_id(speaker_id: int) -> "SpeakerProfile":
        rng = np.random.default_rng(7919 * (speaker_id + 1))
        return SpeakerProfile(
            f0_base=float(rng.uniform(90, 230)),
            tract_factor=float(rng.uniform(0.85, 1.18)),
            breathiness=float(rng.uniform(0.02, 0.12)),
            f0_range=float(rng.uniform(2.0, 6.0)),
        )


def _resonator_sos(freq: float, bw: float, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Second-order resonator section (unit peak gain) as an SOS row."""
    freq = float(np.clip(freq, 60.0, sr / 2 - 200.0))
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    b0 = 1 - 2 * r * np.cos(theta) + r * r  # ~unit DC-normalised peak
    return np.array([b0, 0.0, 0.0, *a])


def _glottal_source(
    f0: np.ndarray, sr: int, rng: np.random.Generator, jitter: float = 0.01
) -> np.ndarray:
    """Differentiated-glottal-flow pulse train for a per-sample f0 track
    (0 ⇒ unvoiced).  Rosenberg-style: polynomial opening phase, sharp
    closure — gives the natural −12 dB/oct source spectrum."""
    n = len(f0)
    out = np.zeros(n, dtype=np.float64)
    phase = 0.0
    period_scale = 1.0
    for i in range(n):
        f = f0[i]
        if f <= 0:
            phase = 0.0
            continue
        phase += f * period_scale / sr
        if phase >= 1.0:
            phase -= 1.0
            period_scale = 1.0 + jitter * rng.standard_normal()
        # Rosenberg pulse (open quotient 0.6), differentiated analytically
        oq = 0.6
        if phase < oq:
            x = phase / oq
            out[i] = 6 * x * (1 - x) / oq  # d/dt of 3x^2-2x^3
        else:
            out[i] = 0.0
    # remove DC, gentle spectral tilt
    out = out - out.mean()
    return sps.lfilter([1.0], [1.0, -0.98], out)


def _format_track(
    targets: list[tuple[float, tuple[float, float, float]]],
    n: int,
    sr: int,
) -> np.ndarray:
    """Piecewise-linear formant tracks ``[n, 3]`` from (time, F1-3) targets."""
    t = np.array([p[0] for p in targets])
    f = np.array([p[1] for p in targets])
    grid = np.arange(n) / sr
    return np.stack([np.interp(grid, t, f[:, j]) for j in range(3)], axis=1)


def _apply_formants(
    source: np.ndarray, tracks: np.ndarray, sr: int, frame: int = 160
) -> np.ndarray:
    """Time-varying cascade formant filter via overlap-add of
    frame-stationary filters (20 ms frames, 10 ms hop, Hann window)."""
    n = len(source)
    win = np.hanning(2 * frame)
    out = np.zeros(n + 2 * frame)
    bws = (90.0, 110.0, 170.0)
    for start in range(0, n, frame):
        seg = source[start : start + 2 * frame]
        if not len(seg):
            break
        w = win[: len(seg)]
        mid = min(start + frame, n - 1)
        sos = np.stack(
            [_resonator_sos(tracks[mid, j], bws[j], sr) for j in range(3)]
        )
        y = sps.sosfilt(sos, seg * w)
        out[start : start + len(seg)] += y
    return out[:n]


def _noise_band(n: int, center: float, bw: float, sr: int, rng) -> np.ndarray:
    noise = rng.standard_normal(n)
    sos = _resonator_sos(center, bw, sr)[None]
    return sps.sosfilt(sos, noise)


# Phone-id table (transcript vocabulary): 0 = pau, then vowels, then
# consonants.  Used by the streaming-S2ST training task (phone-plan
# transcripts are free supervision — the corpus knows what it said).
PHONES = ["pau"] + _VOWEL_KEYS + _CONS_KEYS
PHONE_TO_ID = {p: i for i, p in enumerate(PHONES)}


def plan_phone_ids(plan: list[tuple[str, float]]) -> np.ndarray:
    """Phone-id sequence of an utterance plan (pauses included)."""
    return np.array([PHONE_TO_ID[p] for p, _ in plan], dtype=np.int32)


class FormantSpeechCorpus:
    """Deterministic procedural speech corpus.

    ``utterance(speaker, idx)`` → float32 waveform at 16 kHz, roughly
    1–3 s, peak-normalised to 0.7.

    ``content``: when given, every random draw that defines the
    *linguistic content* (phone plan, accents, prosodic drift, noise
    realisations) is seeded by ``content`` alone, so two speakers
    rendering the same content produce time-aligned parallel utterances
    differing only in vocal identity (f0 base/range, vocal-tract scale,
    breathiness).  This is the data substrate for the voice-cloning
    task (FiLM conditioning on a reference clip): with parallel targets,
    the speaker embedding is *necessary*, not redundant.
    """

    def __init__(self, *, n_speakers: int = 32, sample_rate: int = SAMPLE_RATE):
        self.n_speakers = n_speakers
        self.sr = sample_rate

    def content_arousal(self, content: int) -> float:
        """The arousal an unforced rendering of ``content`` would draw."""
        return float(np.random.default_rng(content).uniform(0.2, 1.0))

    def utterance(
        self,
        speaker: int,
        idx: int,
        *,
        arousal: float | None = None,
        content: int | None = None,
        return_plan: bool = False,
    ):
        sr = self.sr
        prof = SpeakerProfile.from_id(speaker % self.n_speakers)
        if content is None:
            content = (speaker % self.n_speakers) * 1_000_003 + idx
        rng = np.random.default_rng(content)
        if arousal is None:
            arousal = float(rng.uniform(0.2, 1.0))
        rate = 0.85 + 0.5 * arousal            # syllables get shorter when excited

        # --- phone plan: words of 1-3 CV(C) syllables, with pauses ---
        plan: list[tuple[str, float]] = []   # (phone, dur_s)
        n_words = rng.integers(3, 8)
        for w in range(n_words):
            for s in range(rng.integers(1, 4)):
                if rng.random() < 0.85:
                    c = _CONS_KEYS[rng.integers(len(_CONS_KEYS))]
                    plan.append((c, float(rng.uniform(0.04, 0.1)) / rate))
                v = _VOWEL_KEYS[rng.integers(len(_VOWEL_KEYS))]
                plan.append((v, float(rng.uniform(0.07, 0.2)) / rate))
                if rng.random() < 0.25:
                    c = _CONS_KEYS[rng.integers(len(_CONS_KEYS))]
                    plan.append((c, float(rng.uniform(0.03, 0.08)) / rate))
            plan.append(("pau", float(rng.uniform(0.03, 0.15))))
        plan.append(("pau", 0.08))

        audio = self._synthesize(prof, plan, arousal, rng)
        if return_plan:
            return audio, plan, arousal
        return audio

    def render_plan(
        self,
        speaker: int,
        plan: list[tuple[str, float]],
        *,
        arousal: float = 0.6,
        seed: int = 0,
    ) -> np.ndarray:
        """Synthesize an *explicit* phone plan with a speaker's voice —
        the target-language rendering path of the toy translation task
        (translated plans become real speech, giving the unit vocoder
        ground-truth (units, durations, waveform) triples and letting
        ASR-BLEU run on actual audio)."""
        prof = SpeakerProfile.from_id(speaker % self.n_speakers)
        rng = np.random.default_rng((seed * 2_000_003 + speaker) ^ 0x5EED)
        return self._synthesize(prof, plan, arousal, rng)

    def _synthesize(
        self,
        prof: SpeakerProfile,
        plan: list[tuple[str, float]],
        arousal: float,
        rng: np.random.Generator,
    ) -> np.ndarray:
        sr = self.sr
        f0_span = prof.f0_range * (0.6 + 0.9 * arousal)
        total = sum(d for _, d in plan)
        n = int(total * sr) + 1

        # --- prosody: f0 declination + per-syllable accents + jitter ---
        f0 = np.zeros(n)
        voicing = np.zeros(n)
        level = np.zeros(n)
        formant_targets: list[tuple[float, tuple[float, float, float]]] = []
        t = 0.0
        tf = prof.tract_factor
        last_vowel = _VOWELS["a"]
        for phone, dur in plan:
            i0, i1 = int(t * sr), min(int((t + dur) * sr), n)
            seg = slice(i0, i1)
            decl = 2.0 ** (-(t / max(total, 1e-6)) * 3.0 / 12.0)  # −3 st over utt
            accent = 2.0 ** (rng.uniform(-0.5, 1.0) * f0_span / 12.0 / 2)
            if phone in _VOWELS:
                F = tuple(f * tf for f in _VOWELS[phone])
                last_vowel = F
                formant_targets.append((t + dur * 0.5, F))
                f0[seg] = prof.f0_base * decl * accent
                voicing[seg] = 1.0
                level[seg] = 1.0 * (0.7 + 0.5 * arousal)
            elif phone == "pau":
                formant_targets.append((t + dur * 0.5, last_vowel))
            else:
                kind, locus = _CONSONANTS[phone]
                F = (locus[0] * tf, max(locus[0] * tf * 1.4, 900.0), 2500 * tf)
                formant_targets.append((t + dur * 0.5, F))
                if kind in ("vfric", "vstop", "nasal", "liquid"):
                    f0[seg] = prof.f0_base * decl * accent * 0.95
                    voicing[seg] = 1.0 if kind in ("nasal", "liquid") else 0.5
                    level[seg] = 0.6
                else:
                    level[seg] = 0.4
            t += dur
        if not formant_targets:
            formant_targets = [(0.0, last_vowel)]
        formant_targets = [(0.0, formant_targets[0][1])] + formant_targets + [
            (total, formant_targets[-1][1])
        ]

        # micro-prosody: slow random f0 drift (~2 Hz) + jitter handled in source
        drift = sps.lfilter(*sps.butter(2, 3.0 / (sr / 2)), rng.standard_normal(n))
        drift = drift / (np.abs(drift).max() + 1e-9)
        f0 = f0 * (1.0 + 0.03 * drift)

        # --- synthesis ---
        voiced_src = _glottal_source(f0 * (voicing > 0), sr, rng)
        aspiration = rng.standard_normal(n) * (
            prof.breathiness + 0.02 * (1 - voicing)
        )
        tracks = _format_track(formant_targets, n, sr)
        vocal = _apply_formants(voiced_src + aspiration, tracks, sr)

        # smooth amplitude envelope (30 ms attack/decay)
        env = sps.lfilter(*sps.butter(2, 40.0 / (sr / 2)), level)
        env = np.clip(env, 0.0, None)
        out = vocal * env

        # consonant noise layers
        t = 0.0
        for phone, dur in plan:
            i0, i1 = int(t * sr), min(int((t + dur) * sr), n)
            t += dur
            if phone in _VOWELS or phone == "pau" or i1 <= i0:
                continue
            kind, locus = _CONSONANTS[phone]
            m = i1 - i0
            if kind in ("fric", "vfric"):
                band = _noise_band(m, locus[0] * tf, locus[1], sr, rng)
                ramp = np.minimum(np.arange(m), np.arange(m)[::-1]) / max(m / 4, 1)
                out[i0:i1] += 0.35 * band * np.clip(ramp, 0, 1)
            elif kind in ("stop", "vstop"):
                # closure (first 60%) then a 10 ms burst
                burst = int(min(0.01 * sr, m * 0.4))
                j0 = i0 + int(m * 0.6)
                band = _noise_band(burst, locus[0] * tf, locus[1] * 1.5, sr, rng)
                decay = np.exp(-np.arange(burst) / (0.003 * sr))
                out[i0 : i0 + int(m * 0.55)] *= 0.15  # closure
                out[j0 : j0 + burst] += 0.8 * band * decay
            elif kind == "nasal":
                out[i0:i1] *= 0.5
                murmur = _noise_band(m, 250 * tf, 120, sr, rng)
                out[i0:i1] += 0.1 * murmur

        peak = np.abs(out).max() + 1e-9
        return (0.7 * out / peak).astype(np.float32)


class FormantSpeechDataset:
    """BatchLoader-compatible dataset of fixed-length random crops drawn
    from cached procedural utterances."""

    def __init__(
        self,
        *,
        segment_samples: int = 8192,
        size: int = 512,
        n_speakers: int = 32,
        seed: int = 0,
        cache_utterances: int | None = None,
    ):
        self.segment_samples = segment_samples
        self.size = size
        self.corpus = FormantSpeechCorpus(n_speakers=n_speakers)
        self.seed = seed
        self._cache: dict[int, np.ndarray] = {}
        # default: cache the whole corpus (512 utts ≈ 70 MB — regenerating
        # on miss costs ~50 ms/utterance, 10× a train step)
        self._cache_slots = cache_utterances if cache_utterances else size

    def __len__(self) -> int:
        return self.size

    def _utterance(self, key: int) -> np.ndarray:
        if key not in self._cache:
            if len(self._cache) >= self._cache_slots:
                self._cache.pop(next(iter(self._cache)))
            spk = key % self.corpus.n_speakers
            self._cache[key] = self.corpus.utterance(spk, key // self.corpus.n_speakers)
        return self._cache[key]

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 99_991 + idx)
        audio = self._utterance(idx % self.size)
        seg = self.segment_samples
        if len(audio) <= seg:
            return np.pad(audio, (0, seg - len(audio)))
        start = int(rng.integers(0, len(audio) - seg + 1))
        return audio[start : start + seg]


def write_eval_clips(
    out_dir: str,
    *,
    n_clips: int = 16,
    n_speakers: int = 8,
    seed_offset: int = 10_000,
) -> list[str]:
    """Write deterministic held-out eval clips (disjoint utterance ids
    from any training draw) as 16-bit PCM WAVs.  Returns the paths."""
    import wave

    os.makedirs(out_dir, exist_ok=True)
    corpus = FormantSpeechCorpus(n_speakers=n_speakers)
    paths = []
    for i in range(n_clips):
        audio = corpus.utterance(i % n_speakers, seed_offset + i)
        path = os.path.join(out_dir, f"eval_{i:03d}.wav")
        pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes(pcm.tobytes())
        paths.append(path)
    return paths
