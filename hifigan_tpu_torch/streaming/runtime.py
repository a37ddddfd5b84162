"""The incremental S2ST inference runtime.

Counterpart of ``hifigan_tpu/streaming/runtime.py``.  Each policy call
runs

    fbank(prefix) → chunked encoder → source and target CTC argmax
    → policy gate → bounded continuation of the text decoder (greedy,
      beam or HMT beam) → T2U unit CTC with prefix continuation
    → unit vocoder → only the new duration-aligned tail of the waveform.

The source is padded to a bucket of ``source_buckets`` frames and the
units to a bucket of ``UNIT_BUCKETS``, as in the JAX package, and the
padding is part of what is computed: the decoder attends to the encoder
output over the whole source bucket, the T2U transposed convs see the
padded frames, and the unit vocoder's convolutions see the padded units.
So the buckets are kept exactly, or the text and units would differ from
JAX's.

The beam and HMT programs (``_decode_logprobs``, ``_decode_logprobs_hmt``,
``_decode_scores_hmt``, ``_hmt_prefill``, ``_hmt_kv_step``,
``_prefill_lp``, ``_beam_step``) take explicit tensors on the model's
device and return device tensors; the searches of
:mod:`~hifigan_tpu_torch.streaming.beam` bring each step's log-probs to
the host.  A read mask ``read_lens`` shows row ``i`` the first
``read_lens[i]`` encoder frames.  The cross K/V of one encoder output are
broadcast over the rows with ``expand`` (no copy); the self-attention cache
is reordered by parent with :func:`~incremental.gather_beams` (a copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder
from hifigan_tpu_torch.models.streamspeech import StreamSpeechS2ST
from hifigan_tpu_torch.streaming import beam as beam_mod
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


class _HmtKvStepper:
    """The KV-cached scorer of :func:`~beam.hmt_beam_search`.

    ``prefill(tokens, read_lens, n)`` fills a fresh ``[beam_rows,
    max_target_len]`` cache with the committed prefix under each row's
    read mask and sets the index to ``n − 1``, so that the first step
    writes the last committed token again under the candidates' masks;
    ``step(last_tokens, parents, read_lens)`` reorders the cache rows by
    parent (``step_rows`` of them), writes each row's last token under its
    candidate read mask and returns the next-token log-probs ``[R, V]`` and
    the learned write probabilities ``[R]`` (None under the confidence
    gate), on the host.  Positions before the last keep the K/V written
    under the read masks of the steps that wrote them."""

    def __init__(self, inf: "S2STInference", enc: torch.Tensor, *, learned: bool, beam_rows: int,
                 step_rows: int):
        self.inf = inf
        self.learned = learned
        self.beam_rows = beam_rows
        self.step_rows = step_rows
        self.ckv = inc.cross_kv(inf.model.text_decoder, enc)
        self.cache = None

    def prefill(self, tokens: np.ndarray, read_lens: np.ndarray, n: int):
        inf = self.inf
        cache = inc.init_cache(inf.decoder_spec, tokens.shape[0], inf.cfg.max_target_len, inf.device)
        cache = inf._hmt_prefill(self.ckv, inf._ids(tokens), cache, inf._ids(np.maximum(read_lens, 1)))
        self.cache = inc.with_index(cache, max(n - 1, 0))

    def step(self, last_tokens: np.ndarray, parents: np.ndarray, read_lens: np.ndarray):
        inf = self.inf
        lp, wp, self.cache = inf._hmt_kv_step(self.ckv, self.cache, inf._ids(last_tokens), inf._ids(parents),
                                              inf._ids(np.maximum(read_lens, 1)), learned=self.learned)
        return lp.cpu().numpy(), (wp.cpu().numpy() if wp is not None else None)


def _bcast_ckv(ckv, rows: int):
    """The cross K/V ``[n_layers, 1, S, H, hd]`` broadcast to ``rows`` rows
    (``expand``: a view, no copy)."""
    return tuple(a.expand(a.shape[0], rows, *a.shape[2:]) for a in ckv)


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

    def _ids(self, ids) -> torch.Tensor:
        """Host ids (a sequence or an array of any shape) as int64 on the
        device."""
        return torch.tensor(np.asarray(ids, dtype=np.int64)).to(self.device)

    def _read_mask(self, read_lens: torch.Tensor, S: int) -> torch.Tensor:
        """``[N, 1, 1, S]``: row ``i`` sees the first ``read_lens[i]`` frames."""
        return torch.arange(S, device=read_lens.device)[None, None, None, :] < read_lens[:, None, None, None]

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

    # ---- the beam and HMT programs ----

    @torch.no_grad()
    def _decode_logprobs(self, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``[N, L]`` (``enc`` broadcast over the rows) → log-probs
        ``[N, L, V]``."""
        mem = enc.expand(tokens.shape[0], *enc.shape[1:])
        return torch.log_softmax(self.model.text_decoder(mem, tokens), dim=-1)

    @torch.no_grad()
    def _decode_logprobs_hmt(self, enc: torch.Tensor, tokens: torch.Tensor, read_lens: torch.Tensor) -> torch.Tensor:
        """tokens ``[N, L]``, read_lens ``[N]`` → log-probs ``[N, L, V]``, each
        row's encoder memory masked to its read prefix: every (beam × read
        candidate) row in one decoder pass."""
        mem = enc.expand(tokens.shape[0], *enc.shape[1:])
        cross = self._read_mask(read_lens, enc.shape[1])
        return torch.log_softmax(self.model.text_decoder(mem, tokens, cross), dim=-1)

    @torch.no_grad()
    def _decode_scores_hmt(self, enc: torch.Tensor, tokens: torch.Tensor, read_lens: torch.Tensor):
        """As :meth:`_decode_logprobs_hmt`, plus the transition head's write
        probabilities ``[N, L]`` from the same pass."""
        mem = enc.expand(tokens.shape[0], *enc.shape[1:])
        cross = self._read_mask(read_lens, enc.shape[1])
        logits, write_logits = self.model.decoder_scores(mem, tokens, cross)
        return torch.log_softmax(logits, dim=-1), torch.sigmoid(write_logits)

    @torch.no_grad()
    def _hmt_prefill(self, ckv, tokens: torch.Tensor, cache: inc.DecoderCache,
                     read_lens: torch.Tensor) -> inc.DecoderCache:
        """Write the K/V of ``tokens [R, L]`` into ``cache`` under each row's
        read mask (the index is the caller's to set)."""
        cross = self._read_mask(read_lens, ckv[0].shape[2])
        return inc.prefill(self.model.text_decoder, _bcast_ckv(ckv, tokens.shape[0]), tokens, cache, cross)[1]

    @torch.no_grad()
    def _hmt_kv_step(self, ckv, cache: inc.DecoderCache, tokens: torch.Tensor, parents: torch.Tensor,
                     read_lens: torch.Tensor, *, learned: bool):
        """Reorder the cache rows by ``parents``, write ``tokens [R]`` under
        each row's read mask, and return (next-token log-probs ``[R, V]``,
        write probabilities ``[R]`` or None, the cache).  ``learned``: the
        transition head on the step's fp32 features, ``feats @ kernel[:, 0]
        + bias[0]`` through a sigmoid."""
        cross = self._read_mask(read_lens, ckv[0].shape[2])
        cache = inc.gather_beams(cache, parents)
        logits, cache, feats = inc.decode_step(self.model.text_decoder, _bcast_ckv(ckv, tokens.shape[0]), cache,
                                               tokens, cross, return_features=True)
        lp = torch.log_softmax(logits, dim=-1)
        if not learned:
            return lp, None, cache
        head = self.model.transition_head
        return lp, torch.sigmoid(feats.float() @ head.kernel[:, 0] + head.bias[0]), cache

    @torch.no_grad()
    def _prefill_lp(self, ckv, tokens: torch.Tensor, cache: inc.DecoderCache):
        """``prefill`` over ``tokens [R, L]`` → (log-probs ``[R, L, V]``, the
        cache)."""
        logits, cache = inc.prefill(self.model.text_decoder, _bcast_ckv(ckv, tokens.shape[0]), tokens, cache)
        return torch.log_softmax(logits, dim=-1), cache

    @torch.no_grad()
    def _beam_step(self, ckv, cache: inc.DecoderCache, tokens: torch.Tensor, parents: torch.Tensor):
        """The KV-cached beam step: reorder the cache rows by ``parents``,
        write ``tokens [R]``, return (next-token log-probs ``[R, V]``, the
        cache)."""
        cache = inc.gather_beams(cache, parents)
        logits, cache = inc.decode_step(self.model.text_decoder, _bcast_ckv(ckv, tokens.shape[0]), cache, tokens)
        return torch.log_softmax(logits, dim=-1), cache

    @torch.no_grad()
    def continue_text_beam(self, enc: torch.Tensor, prefix_ids: List[int], *, beam_size: int = 5,
                           max_new_tokens: Optional[int] = None, length_penalty: float = 1.0,
                           kv_cached: bool = True) -> List[int]:
        """The best beam's continuation of BOS + ``prefix_ids`` (up to
        ``max_new_tokens`` tokens, EOS included when reached).

        KV-cached (the default): the seed is prefilled once into a
        ``[beam_size, max_target_len]`` cache and each beam step is one
        :meth:`_beam_step`.  ``kv_cached=False``: each step is a full decoder
        pass over the live beams' buffers (padded to ``beam_size + 1``
        rows), the plain form."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        if kv_cached:
            seed = ([cfg.bos_id] + list(prefix_ids))[: cfg.max_target_len]
            n = len(seed)
            ckv = inc.cross_kv(self.model.text_decoder, enc)
            cache = inc.init_cache(self.decoder_spec, beam_size, cfg.max_target_len, self.device)
            buf = np.zeros((beam_size, cfg.max_target_len), np.int64)
            buf[:, :n] = seed
            lp_all, cache = self._prefill_lp(ckv, self._ids(buf), cache)
            state = {"cache": inc.with_index(cache, n)}

            def step_fn(tokens: np.ndarray, parents: np.ndarray) -> np.ndarray:
                lp, state["cache"] = self._beam_step(ckv, state["cache"], self._ids(tokens),
                                                     self._ids(parents))
                return lp.cpu().numpy()

            hyps = beam_mod.kv_beam_search(lp_all[0, n - 1].cpu().numpy(), step_fn, seed_len=n,
                                           beam_size=beam_size, max_new_tokens=max_new, max_len=cfg.max_target_len,
                                           eos_id=cfg.eos_id, length_penalty=length_penalty)
            return hyps[0].tokens if hyps else []

        rows = beam_size + 1

        def score_fn(tokens: np.ndarray) -> np.ndarray:
            padded = np.zeros((rows, tokens.shape[1]), np.int64)
            padded[: tokens.shape[0]] = tokens
            return self._decode_logprobs(enc, self._ids(padded)).cpu().numpy()[: tokens.shape[0]]

        hyps = beam_mod.beam_search(score_fn, prefix=prefix_ids, beam_size=beam_size, max_new_tokens=max_new,
                                    max_len=cfg.max_target_len, bos_id=cfg.bos_id, eos_id=cfg.eos_id,
                                    length_penalty=length_penalty)
        return hyps[0].tokens if hyps else []

    @torch.no_grad()
    def continue_text_hmt(self, enc: torch.Tensor, prefix_ids: List[int], *, src_len: int, source_finished: bool,
                          state: Optional[beam_mod.HmtBeamState] = None, beam_size: int = 4,
                          cands_per_token: int = 4, read_stride: Optional[int] = None,
                          max_new_tokens: Optional[int] = None, write_threshold: float = 0.5,
                          read_penalty: float = 0.1, transition: str = "confidence",
                          kv_cached: bool = True) -> beam_mod.HmtBeamState:
        """One pass of the HMT simultaneous beam
        (:func:`~beam.hmt_beam_search`) continuing BOS + ``prefix_ids``:
        ``src_len`` encoder frames received, reads advancing by
        ``read_stride`` (one encoder chunk by default).  Returns the
        updated, resumable :class:`~beam.HmtBeamState`.

        ``transition="learned"``: the READ/WRITE gate is the trained
        transition head's write probability; ``"confidence"``: the top
        token's probability.

        ``kv_cached=True`` (the default): the committed prefix is prefilled
        once a call under each beam's read mask and each beam iteration is
        one :meth:`_hmt_kv_step` over all (beam × read candidate) rows, so
        earlier positions keep the K/V of the read masks they were written
        under.  ``kv_cached=False``: each iteration re-decodes every row's
        whole buffer under its read mask, which is another function, not a
        slower form of the same one."""
        cfg = self.cfg
        common = dict(prefix=prefix_ids, src_len=src_len, source_finished=source_finished, state=state,
                      beam_size=beam_size, cands_per_token=cands_per_token,
                      read_stride=read_stride or self.chunk, max_new_tokens=max_new_tokens or cfg.max_new_tokens,
                      max_len=cfg.max_target_len, bos_id=cfg.bos_id, eos_id=cfg.eos_id,
                      write_threshold=write_threshold, read_penalty=read_penalty)
        if kv_cached:
            stepper = _HmtKvStepper(self, enc, learned=(transition == "learned"), beam_rows=beam_size,
                                    step_rows=beam_size * cands_per_token)
            return beam_mod.hmt_beam_search(None, stepper=stepper, **common)

        if transition == "learned":
            def score_fn(tokens: np.ndarray, read_lens: np.ndarray):
                lp, pw = self._decode_scores_hmt(enc, self._ids(tokens), self._ids(read_lens))
                return lp.cpu().numpy(), pw.cpu().numpy()
        else:
            def score_fn(tokens: np.ndarray, read_lens: np.ndarray):
                return self._decode_logprobs_hmt(enc, self._ids(tokens), self._ids(read_lens)).cpu().numpy()

        return beam_mod.hmt_beam_search(score_fn, **common)

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
