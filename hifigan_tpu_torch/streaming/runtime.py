"""The incremental S2ST inference runtime, greedy decoding.

Counterpart of ``hifigan_tpu/streaming/runtime.py``.  Each policy call
runs

    fbank(prefix) → chunked encoder → source and target CTC argmax
    → policy gate → bounded greedy continuation of the text decoder
    → T2U unit CTC with prefix continuation → unit vocoder
    → only the new duration-aligned tail of the waveform.

The source is padded to a bucket of ``source_buckets`` frames and the
units to a bucket of ``UNIT_BUCKETS``, as in the JAX package, and the
padding is part of what is computed: the decoder attends to the encoder
output over the whole source bucket, the T2U transposed convs see the
padded frames, and the unit vocoder's convolutions see the padded units.
So the buckets are kept exactly, or the text and units would differ from
JAX's.  The beam and HMT continuations are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder
from hifigan_tpu_torch.models.streamspeech import StreamSpeechS2ST
from hifigan_tpu_torch.streaming import incremental as inc
from hifigan_tpu_torch.streaming.decode import ctc_greedy_collapse, ctc_prefix_frames

UNIT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
T2U_UPSAMPLING = 8  # the T2U encoder's three stride-2 transposed convs


class DecoderSession:
    """One stream's incremental decoding state: the self-attention KV cache
    and the tokens it holds (BOS + the committed prefix), kept across
    policy calls and pruned on retraction."""

    def __init__(self, inf: "S2STInference"):
        self.inf = inf
        self.cache = inc.init_cache(inf.decoder_spec, 1, inf.cfg.max_target_len, inf.device)
        self.tokens: List[int] = []

    def sync(self, ckv, seq: List[int]) -> torch.Tensor:
        """Make the cache hold exactly ``seq`` and return the next-token
        logits ``[1, vocab]``.  The longest common prefix is kept; a
        retraction lowers the write index; one missing token is one
        :func:`~incremental.decode_step`, more are one
        :func:`~incremental.prefill`; when the cache already holds ``seq``,
        the last token is stepped again (it rewrites the same K/V)."""
        common = 0
        for a, b in zip(self.tokens, seq):
            if a != b:
                break
            common += 1
        if common < len(self.tokens):
            self.cache = inc.with_index(self.cache, common)
            self.tokens = self.tokens[:common]
        gap = seq[common:]
        decoder = self.inf.model.text_decoder
        if not gap:
            cache = inc.with_index(self.cache, len(self.tokens) - 1)
            logits, self.cache = inc.decode_step(decoder, ckv, cache, self.inf._ids([self.tokens[-1]]))
            return logits
        if len(gap) == 1:
            logits, self.cache = inc.decode_step(decoder, ckv, self.cache, self.inf._ids(gap))
        else:
            n = min(len(seq), self.inf.cfg.max_target_len)
            all_logits, cache = inc.prefill(decoder, ckv, self.inf._ids(seq[:n])[None], self.cache)
            self.cache = inc.with_index(cache, n)
            logits = all_logits[:, n - 1]
        self.tokens = list(seq)
        return logits


def _bucket(n: int, align: int, buckets: Sequence[int]) -> int:
    n = ((n + align - 1) // align) * align
    for b in buckets:
        if b >= n:
            return b
    return n


@dataclass
class S2STInferenceConfig:
    source_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    max_target_len: int = 128
    max_new_tokens: int = 8
    bos_id: int = 1
    eos_id: int = 2
    ctc_blank: int = 0
    # encoder-fed unit streams: insert one pause unit where the blank run
    # between two units is longer than this many T2U frames (None: off);
    # see decode.ctc_prefix_frames
    unit_silence_gap: Optional[int] = 64


class S2STInference:
    """The programs of a streaming session over a ``StreamSpeechS2ST`` and a
    ``CodeVocoder``, on the model's device.  Every call runs without
    autograd."""

    def __init__(self, model: StreamSpeechS2ST, code_vocoder: Optional[CodeVocoder] = None,
                 cfg: S2STInferenceConfig = S2STInferenceConfig()):
        self.model = model
        self.code_vocoder = code_vocoder
        self.cfg = cfg
        self.chunk = model.config.chunk_size
        self.device = next(model.parameters()).device
        self.decoder_spec = inc.DecoderSpec.of(model.text_decoder)

    def _ids(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(ids), dtype=torch.int64).to(self.device)

    def _padded_ids(self, ids: Sequence[int], length: int) -> torch.Tensor:
        buf = np.zeros((1, length), np.int64)
        buf[0, :len(ids)] = ids
        return torch.from_numpy(buf).to(self.device)

    @torch.no_grad()
    def encode_prefix(self, mel_frames: np.ndarray) -> Optional[dict]:
        """``mel_frames [T, n_mels]`` → the encoder output over the source
        bucket (``"enc"``, on the device) and the prefix's collapsed CTC
        streams and T2U unit argmax (on the host)."""
        T = mel_frames.shape[0]
        if T == 0:
            return None
        bucket = _bucket(T, self.chunk, self.cfg.source_buckets)
        mel = np.zeros((1, bucket, mel_frames.shape[1]), np.float32)
        mel[0, :T] = mel_frames
        m = self.model
        enc = m.encoder(torch.from_numpy(mel).to(self.device), chunked=True)
        ids = torch.cat([m.source_ctc(enc).argmax(-1), m.target_ctc(enc).argmax(-1),
                         m.t2u_encoder(enc).argmax(-1)], dim=-1)[0].cpu().numpy()
        src_ids, tgt_ids, unit_ids = ids[:bucket], ids[bucket:2 * bucket], ids[2 * bucket:]
        src_tokens, src_frames = ctc_greedy_collapse(src_ids[:T], self.cfg.ctc_blank)
        tgt_tokens, tgt_frames = ctc_greedy_collapse(tgt_ids[:T], self.cfg.ctc_blank)
        return {
            "enc": enc,
            "valid_frames": T,
            "src_tokens": src_tokens,
            "src_token_frames": src_frames,
            "tgt_tokens": tgt_tokens,
            "tgt_token_frames": tgt_frames,
            "unit_argmax": unit_ids[: T * T2U_UPSAMPLING],
        }

    def new_session(self) -> DecoderSession:
        """A fresh KV-cache state, one a streaming session."""
        return DecoderSession(self)

    @torch.no_grad()
    def continue_text(self, enc: torch.Tensor, prefix_ids: List[int], max_new_tokens: Optional[int] = None,
                      session: Optional[DecoderSession] = None) -> List[int]:
        """Greedy-decode up to ``max_new_tokens`` tokens after BOS +
        ``prefix_ids`` (stopping at EOS, which is returned).

        With a :class:`DecoderSession` it is KV-cached: cross K/V are
        projected once for this ``enc``, the session's cache is synced to
        the prefix, and each new token is one :func:`~incremental.decode_step`.
        Without one, each token is a full causal pass of the decoder over
        the ``max_target_len`` token buffer (the plain form, for checks)."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        seq = [cfg.bos_id] + list(prefix_ids)
        n = min(len(seq), cfg.max_target_len)
        new: List[int] = []
        decoder = self.model.text_decoder

        if session is not None:
            ckv = inc.cross_kv(decoder, enc)
            logits = session.sync(ckv, seq[:n])
            while max_new > 0:
                nxt = int(logits.argmax(-1)[0])
                new.append(nxt)
                if nxt == cfg.eos_id or len(new) >= max_new or len(session.tokens) >= cfg.max_target_len - 1:
                    break
                logits, session.cache = inc.decode_step(decoder, ckv, session.cache, self._ids([nxt]))
                session.tokens.append(nxt)
            return new

        seq = seq[:n]
        for _ in range(max_new):
            if n >= cfg.max_target_len:
                break
            logits = decoder(enc, self._padded_ids(seq, cfg.max_target_len))
            nxt = int(logits[0, n - 1].argmax())
            new.append(nxt)
            if nxt == cfg.eos_id:
                break
            seq.append(nxt)
            n += 1
        return new

    def units_from_prefix(self, unit_argmax: np.ndarray, emitted_units: int):
        """Unit CTC prefix continuation of the encoder-fed T2U stream, with
        pause units inserted at long blank runs."""
        return ctc_prefix_frames(unit_argmax, emitted_units, self.cfg.ctc_blank,
                                 silence_gap=self.cfg.unit_silence_gap)

    @torch.no_grad()
    def units_from_text(self, enc: torch.Tensor, text_ids: List[int], emitted_units: int):
        """Decoder-fed units: the unit CTC argmax over the decoder features
        of BOS + the committed text (padded to ``max_target_len``), with the
        same prefix continuation."""
        if not text_ids:
            return [], emitted_units
        cfg = self.cfg
        seq = ([cfg.bos_id] + list(text_ids))[: cfg.max_target_len]
        logits = self.model.decoder_units(enc, self._padded_ids(seq, cfg.max_target_len))
        valid = logits.argmax(-1)[0, : len(seq) * T2U_UPSAMPLING].cpu().numpy()
        return ctc_prefix_frames(valid, emitted_units, cfg.ctc_blank)

    @torch.no_grad()
    def synthesize_tail(self, all_units: List[int], n_new_units: int) -> np.ndarray:
        """Vocode all units so far (padded to a unit bucket) and return the
        samples of the last ``n_new_units``: their durations' sum × the
        upsampling ratio, ending at the real units' last sample."""
        if self.code_vocoder is None:
            raise RuntimeError("no CodeVocoder attached")
        if not all_units or n_new_units == 0:
            return np.zeros(0, np.float32)
        U = len(all_units)
        u_bucket = _bucket(U, 8, UNIT_BUCKETS)
        wav, dur, n_samples = self.code_vocoder(self._padded_ids(all_units, u_bucket))
        ratio = self.code_vocoder.config.upsample_ratio
        dur = dur[0].cpu().numpy()
        total_real = int(n_samples[0]) - int(dur[U:].sum()) * ratio  # padded units have durations too
        n_new = int(dur[U - n_new_units: U].sum()) * ratio
        return wav[0, 0, max(0, total_real - n_new): total_real].cpu().numpy()
