"""CTC decoding on the host: greedy collapse, prefix continuation with
pause reinsertion, whole-word trimming.

The port's own copy of ``hifigan_tpu/streaming/decode.py`` (numpy and the
standard library; the same results).  The argmax runs on the device inside
the encoder program; the collapse runs here on the short id sequence.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def ctc_greedy_collapse(ids: Sequence[int], blank: int = 0) -> Tuple[List[int], List[int]]:
    """Collapse repeats, then drop blanks.  Returns (tokens, frames):
    ``frames[i]`` is the first frame at which token i appears."""
    tokens: List[int] = []
    frames: List[int] = []
    prev = None
    for t, i in enumerate(np.asarray(ids).reshape(-1).tolist()):
        if i != prev:
            if i != blank:
                tokens.append(int(i))
                frames.append(t)
            prev = i
    return tokens, frames


def ctc_prefix_frames(ids: Sequence[int], prefix_len: int, blank: int = 0,
                      silence_gap: int | None = None) -> Tuple[List[int], int]:
    """Prefix continuation: collapse the whole argmax sequence and return
    (the tokens beyond the first ``prefix_len``, the total token count).

    ``silence_gap`` (unit streams): the unit vocabulary uses id 0 both as
    the CTC blank and as the pause unit, so a plain collapse never emits a
    pause.  Where more than ``silence_gap`` frames separate two emitted
    units (or the first unit from frame 0), one pause unit (``blank``) is
    inserted before the later one.  The insertion is prefix-stable: the
    pause before token i + 1 exists exactly when token i + 1 first appears,
    so an emitted prefix never changes."""
    tokens, frames = ctc_greedy_collapse(ids, blank)
    if silence_gap is not None and tokens:
        out: List[int] = []
        prev_f = 0
        for tok, f in zip(tokens, frames):
            if f - prev_f > silence_gap:
                out.append(blank)
            out.append(tok)
            prev_f = f
        tokens = out
    return tokens[prefix_len:], len(tokens)


def trim_to_whole_words(tokens: List[str], *, word_boundary_marker: str = "▁") -> List[str]:
    """Drop a trailing incomplete word: keep the tokens before the last one
    that starts a word (``▁``), or none if no token starts one."""
    last_boundary = None
    for i in range(len(tokens) - 1, -1, -1):
        if tokens[i].startswith(word_boundary_marker):
            last_boundary = i
            break
    if last_boundary is None:
        return []
    return tokens[:last_boundary]
