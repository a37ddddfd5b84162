"""Checkpoints of a whole train state, one ``torch.save`` file a step.

Counterpart of ``hifigan_tpu/train/checkpoint.py`` (orbax there), with its
API: ``save`` / ``restore`` / ``latest_step`` / ``all_steps`` / ``wait`` /
``close``, step-based retention of the newest ``max_to_keep``, saves only
at multiples of ``save_interval`` unless forced, and a save of a step
already on disk (or older than the newest) a no-op.  A file holds
:meth:`GanTrainState.state_dict` (both models, both optimisers' states and
the step) or :meth:`EncoderTrainState.state_dict` (the two encoders with
their heads, their two optimisers and the step): any state with
``state_dict``, ``load_state_dict``, ``step`` and ``device``.  It is
written to a temporary name and renamed, so a file named
``<step>.pt`` is whole.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch


_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """``save(state)`` / ``restore(state)`` / ``latest_step()`` over the
    files ``<directory>/<step>.pt``, keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, *, max_to_keep: int = 5, save_interval: int = 1):
        self._dir = os.path.abspath(directory)
        self._max_to_keep, self._save_interval = max_to_keep, save_interval
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def save(self, state, *, metadata: Optional[dict] = None, force: bool = False) -> bool:
        """Write ``state`` at ``state.step``; returns whether it wrote."""
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        if not force and step % self._save_interval:
            return False
        tmp = self._path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        if metadata is not None:
            with open(os.path.join(self._dir, f"meta_{step}.json"), "w") as f:
                json.dump(metadata, f, indent=2, default=str)
        for old in self.all_steps()[: -self._max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load step ``step`` (default: the newest) into ``state``, on its
        devices; returns it."""
        state.load_state_dict(self.load(step, map_location=state.device))
        return state

    def load(self, step: Optional[int] = None, *, map_location=None) -> dict:
        """The state dict saved at step ``step`` (default: the newest), its
        tensors memory-mapped from the file and moved to ``map_location``
        as they are read (so a caller that takes one part of it reads only
        that part)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True, mmap=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
