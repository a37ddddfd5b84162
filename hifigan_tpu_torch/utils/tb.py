"""TensorBoard scalar events, gated on the ``tensorboard`` package.

Counterpart of ``hifigan_tpu/utils/tb.py``: a live :class:`ScalarWriter`
that ``cli train`` writes beside ``metrics.jsonl`` (into
``<checkpoint_dir>/tensorboard/``), :func:`export_metrics_jsonl`, which
renders an existing ``metrics.jsonl`` into an event file after the fact,
and :func:`prune_metrics`, which every trainer of the CLI runs on resume.
Without ``tensorboard`` the writer does nothing and says so once.

The event file is the one tensorboard's ``EventFileWriter`` writes (the
``brain.Event:2`` version record, then one ``Event`` a call, as TFRecords),
written here with tensorboard's ``RecordWriter`` on a plain file:
``EventFileWriter`` opens its file through TensorFlow's ``gfile`` and so
imports TensorFlow wherever it is installed, seconds of start-up for a
file of a few records.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Optional

log = logging.getLogger(__name__)

try:
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.proto.summary_pb2 import Summary
    from tensorboard.summary.writer.record_writer import RecordWriter

    HAVE_TENSORBOARD = True
except ImportError:
    HAVE_TENSORBOARD = False


class ScalarWriter:
    """Scalar event writer into ``logdir``; a no-op without tensorboard."""

    def __init__(self, logdir: str):
        self._file = self._records = None
        if not HAVE_TENSORBOARD:
            log.warning("tensorboard not available; scalar events disabled")
            return
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}.{id(self)}"
        self._file = open(os.path.join(logdir, name), "wb")
        self._records = RecordWriter(self._file)
        self._records.write(Event(wall_time=time.time(), file_version="brain.Event:2").SerializeToString())
        self.flush()

    def write(self, step: int, scalars: dict, wall_time: Optional[float] = None) -> None:
        """One event at ``step`` holding each int or float of ``scalars``."""
        if self._records is None:
            return
        summary = Summary(value=[Summary.Value(tag=k, simple_value=float(v))
                                 for k, v in scalars.items() if isinstance(v, (int, float))])
        event = Event(wall_time=wall_time or time.time(), step=int(step), summary=summary)
        self._records.write(event.SerializeToString())

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = self._records = None


_NON_METRIC_KEYS = {"step", "epoch", "wall_s"}


def prune_metrics(metrics_path: str, resume_step: int) -> int:
    """Drop the ``metrics.jsonl`` rows past ``resume_step``, rows out of
    step order and rows that do not parse, so that a run resumed from an
    older checkpoint appends no duplicate steps.  Rewrites the file
    atomically, and only if a row goes; returns the number of rows dropped
    (blank lines are skipped, not counted)."""
    if not os.path.exists(metrics_path):
        return 0
    kept, dropped, last = [], 0, -1
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                step = int(json.loads(line).get("step", -1))
            except (json.JSONDecodeError, TypeError, ValueError):
                dropped += 1
                continue
            if step > resume_step or step <= last:
                dropped += 1
            else:
                kept.append(line)
                last = step
    if dropped:
        tmp = metrics_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(row + "\n" for row in kept))
        os.replace(tmp, metrics_path)
    return dropped


def export_metrics_jsonl(metrics_path: str, logdir: str) -> int:
    """Write the rows of a ``metrics.jsonl`` log as events into ``logdir``
    (every key but ``step``, ``epoch`` and ``wall_s``); returns the number
    of rows exported."""
    writer = ScalarWriter(logdir)
    n = 0
    try:
        with open(metrics_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                writer.write(int(rec.get("step", n)), {k: v for k, v in rec.items() if k not in _NON_METRIC_KEYS})
                n += 1
    finally:
        writer.close()
    return n
