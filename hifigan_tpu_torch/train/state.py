"""Train state: the vocoder, the discriminators, their two optimisers and
the step count; optax's warmup-cosine schedule.

Counterpart of ``hifigan_tpu/train/state.py``.  Each optimiser is optax's
``chain(clip_by_global_norm?, adam(w)(warmup_cosine_decay_schedule))``
written with ``torch.optim``: Adam(β 0.8, 0.99, eps 1e-8), AdamW when
``weight_decay > 0``, the learning rate set from the schedule before each
update, and optional clipping by the global norm as optax clips.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable

import torch

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.models.discriminators import Discriminators
from hifigan_tpu_torch.models.generator import GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.train.losses import LossWeights


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the JAX package's defaults): lr 2e-4,
    2000 warmup steps, cosine decay to 1% over 1e6 steps."""

    learning_rate: float = 2e-4
    beta1: float = 0.8
    beta2: float = 0.99
    warmup_steps: int = 2000
    decay_steps: int = 1_000_000
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # 0 = off
    loss_weights: LossWeights = LossWeights()
    mel: MelConfig = MelConfig()
    generator: GeneratorConfig = GeneratorConfig()
    precompute_embeddings: bool = False  # True: batches carry "speaker" and "emotion" embeddings
    ecapa_channels: int = 512
    emo_hidden: int = 512
    emo_layers: int = 6
    emo_heads: int = 8


def warmup_cosine_decay(count: int, init: float, peak: float, warmup: int, decay: int, end: float) -> float:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)``
    at update ``count`` (0 for the first update): linear from ``init`` to
    ``peak`` over ``warmup`` updates, then cosine from ``peak`` to ``end``
    over ``decay - warmup`` updates, then flat at ``end``.  In float64,
    where optax computes in fp32: the two differ by under one fp32 ulp of
    ``peak``."""
    if count < warmup:
        return init + (peak - init) * count / warmup
    t = min(count - warmup, decay - warmup) / (decay - warmup)
    alpha = end / peak if peak else 0.0
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """The GAN schedule, ``optax.warmup_cosine_decay_schedule(0, lr,
    warmup_steps, decay_steps, lr / 100)``, at update ``count``."""
    return warmup_cosine_decay(count, 0.0, cfg.learning_rate, cfg.warmup_steps, cfg.decay_steps,
                               cfg.learning_rate / 100)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float, norm: torch.Tensor | None = None) -> None:
    """Scale ``grads`` in place by ``max_norm / ‖grads‖`` when their global
    norm is at least ``max_norm`` (optax's rule: no 1e-6 in the divisor,
    unlike ``torch.nn.utils.clip_grad_norm_``).  ``norm``: the global norm
    when the caller has it (a sharded model's spans ranks).  No host sync."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class ScheduledAdam:
    """Adam (AdamW when ``weight_decay > 0``) on ``params``, with the
    learning rate ``schedule(count)`` at ``count``, the number of updates
    applied so far, and optional global-norm clipping first.  A parameter
    whose ``.grad`` is None is skipped (optax would decay its moments with a
    zero gradient): a caller that needs the decay sets a zero gradient.  On
    the card it runs ``torch.optim``'s fused kernels.  ``global_norm(params)``,
    when set, gives the norm that clipping divides by (the tensor-parallel
    step sets it: a sharded parameter's norm spans ranks)."""

    def __init__(self, params, schedule: Callable[[int], float], *, betas: tuple[float, float],
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        self.params, self.schedule, self.grad_clip, self.count = list(params), schedule, grad_clip, 0
        self.global_norm: Callable | None = None
        fused = self.params[0].device.type == "cuda"
        kwargs = dict(lr=0.0, betas=betas, eps=1e-8, fused=fused)
        if weight_decay > 0:
            self.adam = torch.optim.AdamW(self.params, weight_decay=weight_decay, **kwargs)
        else:
            self.adam = torch.optim.Adam(self.params, weight_decay=0.0, **kwargs)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Apply one update from each parameter's ``.grad``."""
        if self.grad_clip > 0:
            params = [p for p in self.params if p.grad is not None]
            norm = self.global_norm(params) if self.global_norm is not None else None
            clip_by_global_norm([p.grad for p in params], self.grad_clip, norm)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params, cfg: TrainConfig) -> ScheduledAdam:
    """optax's ``chain(clip_by_global_norm?, adam(w)(warmup_cosine_decay_schedule))``
    of ``cfg``: :func:`learning_rate`, betas ``(cfg.beta1, cfg.beta2)``."""
    if cfg.decay_steps <= cfg.warmup_steps:
        raise ValueError(f"decay_steps ({cfg.decay_steps}) must exceed warmup_steps ({cfg.warmup_steps})")
    return ScheduledAdam(params, functools.partial(learning_rate, cfg), betas=(cfg.beta1, cfg.beta2),
                         weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)


@dataclass
class GanTrainState:
    """Everything a training run carries from step to step; ``state_dict``
    is what a checkpoint holds.  ``vocoder`` is the generator under
    training: the ``ModifiedVocoder`` of :func:`create_train_state`, or the
    unit vocoder's ``CodeVocoder``
    (:func:`hifigan_tpu_torch.train.unit_vocoder.create_unit_vocoder_state`)."""

    vocoder: torch.nn.Module
    discriminators: Discriminators
    gen_opt: ScheduledAdam = field(repr=False)
    disc_opt: ScheduledAdam = field(repr=False)
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.vocoder.parameters()).device

    def state_dict(self) -> dict:
        return {"step": self.step, "vocoder": self.vocoder.state_dict(),
                "discriminators": self.discriminators.state_dict(),
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.vocoder.load_state_dict(state["vocoder"])
        self.discriminators.load_state_dict(state["discriminators"])
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.step = int(state["step"])


def create_train_state(
    cfg: TrainConfig = TrainConfig(),
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> GanTrainState:
    """The vocoder (generator + extractor at ``cfg``'s widths) and the
    discriminators, weights drawn from ``seed`` by the JAX package's
    initialisers, on ``device``, computing in ``dtype``; fresh optimisers."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    vocoder = ModifiedVocoder(cfg.generator, cfg.ecapa_channels, cfg.emo_hidden, cfg.emo_layers, cfg.emo_heads,
                              dtype, gen=gen).to(device)
    discs = Discriminators(dtype=dtype, gen=gen).to(device)
    return GanTrainState(vocoder, discs, make_optimizer(vocoder.parameters(), cfg),
                         make_optimizer(discs.parameters(), cfg))
