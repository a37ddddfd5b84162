"""The voice-cloning task's corpus keys.

Counterpart of the key constants of ``hifigan_tpu/train/cloning.py``: the
content and reference keys of the parallel formant corpus that the cloning
trainer draws from, disjoint from every legacy ``speaker * 1_000_003 +
idx`` draw and from the evaluation clips' ``10_000 + i``.  The held-out
transfer grid of :mod:`hifigan_tpu_torch.eval.cloning_eval` offsets both.
The trainer itself is not ported yet.
"""

CONTENT_KEY_BASE = 50_000_000
REF_KEY_BASE = 60_000_000
