"""The alternating GAN train step, and the eval step.

Counterpart of ``hifigan_tpu/train/train_step.py``:

1. ``fake = G(mel)``, mel computed from the real audio on the device;
2. discriminator update on ``(real, fake.detach())``;
3. generator update **against the updated discriminator**: adversarial +
   10·feature matching + 45·mel L1 (+ the optional multi-resolution STFT
   loss), the mel of the generated audio by the real log-mel transform.

The generator runs with ``step=grc_step_reference``: the CUDA GRC-step
kernel has no backward, and the JAX package trains on its XLA chain, not on
the Pallas kernel, for the same reason.  Phase 3 reuses phase 1's graph:
the generator's parameters do not change in between, so the values are
those of a second forward.  The discriminators' parameters are frozen
during phase 3, so its backward leaves them alone; after a step each
parameter's ``.grad`` is the gradient its optimiser applied.  The eval step
runs under ``no_grad`` on the kernel path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step_reference
from hifigan_tpu_torch.ops.stft import log_mel_spectrogram, multi_resolution_stft_loss
from hifigan_tpu_torch.train.losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    mel_l1_loss,
)
from hifigan_tpu_torch.train.state import GanTrainState, TrainConfig


def audio_to_mel(audio: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """``[B, T] → [B, n_mels, T // hop]`` log-mel, frames trimmed so that the
    generator maps it back to exactly ``T`` samples."""
    mel = log_mel_spectrogram(audio, cfg.mel)
    return mel[:, : audio.shape[-1] // cfg.mel.hop_length, :].transpose(1, 2)


def _as_batch(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _mel_and_real(batch: dict, cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    real = batch["audio"]
    if real.dim() == 3:
        real = real[:, 0, :]
    mel = batch.get("mel")
    if mel is None:
        mel = audio_to_mel(real, cfg)
    return mel, real[:, : mel.shape[-1] * cfg.mel.hop_length]


def discriminator_phase(state: GanTrainState, real: torch.Tensor, fake: torch.Tensor, w,
                        grad_sync: Optional[Callable] = None) -> torch.Tensor:
    """One discriminator update on ``(real, fake.detach())``; returns its
    loss.  ``grad_sync(optimiser)`` runs between the backward and the update."""
    discs = state.discriminators
    out_real, out_fake = discs(real), discs(fake.detach())
    d_loss = discriminator_loss(out_real["mpd_outputs"] + out_real["msd_outputs"],
                                out_fake["mpd_outputs"] + out_fake["msd_outputs"], w.adversarial_type)
    state.disc_opt.zero_grad()
    d_loss.backward()
    if grad_sync is not None:
        grad_sync(state.disc_opt)
    state.disc_opt.step()
    return d_loss


def generator_losses(discs, real: torch.Tensor, fake: torch.Tensor, fake_mel: torch.Tensor,
                     target_mel: torch.Tensor, w, deep_feature_matching: bool) -> tuple[torch.Tensor, dict]:
    """The generator's weighted loss against ``discs`` (their parameters
    take no gradient here) and its parts: adversarial, feature matching
    (over the final outputs, or every layer's maps when
    ``deep_feature_matching``), mel L1 of ``fake_mel`` against
    ``target_mel``, and the multi-resolution STFT loss when it is weighted."""
    discs.requires_grad_(False)
    try:
        with torch.no_grad():
            out_real = discs(real)
        out_fake = discs(fake)
    finally:
        discs.requires_grad_(True)
    adv = generator_adversarial_loss(out_fake["mpd_outputs"] + out_fake["msd_outputs"], w.adversarial_type)
    key = "features" if deep_feature_matching else "outputs"
    fm = feature_matching_loss(out_real[f"mpd_{key}"] + out_real[f"msd_{key}"],
                               out_fake[f"mpd_{key}"] + out_fake[f"msd_{key}"])
    mel_loss = mel_l1_loss(fake_mel, target_mel)
    total = w.adversarial * adv + w.feature_matching * fm + w.mel * mel_loss
    metrics = {"adv_loss": adv, "fm_loss": fm, "mel_loss": mel_loss}
    if w.multi_res_stft > 0:
        stft_loss = multi_resolution_stft_loss(fake, real)
        total = total + w.multi_res_stft * stft_loss
        metrics["stft_loss"] = stft_loss
    return total, metrics


def fuse_steps(step: Callable, multi_steps: int = 1) -> Callable:
    """``fused(state, batches, *args)``: ``multi_steps`` calls of ``step(state,
    batch, *args)`` in one call, the metrics the window's means (JAX's
    ``lax.scan`` and ``tree_map(mean)``).  ``batches``: a ``torch.Generator``
    (each step draws its own batch with it) or a list of ``multi_steps``
    drawn batches; with ``multi_steps <= 1``, ``step`` itself."""
    if multi_steps <= 1:
        return step

    def fused(state, batches, *args):
        if isinstance(batches, torch.Generator):
            batches = [batches] * multi_steps
        if len(batches) != multi_steps:
            raise ValueError(f"{len(batches)} batches for {multi_steps} fused steps")
        window = [step(state, b, *args)[1] for b in batches]
        return state, {k: torch.stack([m[k] for m in window]).mean() for k in window[0]}

    return fused


def make_train_step(
    cfg: TrainConfig,
    *,
    deep_feature_matching: bool = False,
    remat: bool = False,
    multi_steps: int = 1,
    sample_fn: Optional[Callable] = None,
) -> Callable[[GanTrainState, object], tuple[GanTrainState, dict]]:
    """``step(state, batch) → (state, metrics)``; ``state`` is updated in
    place and returned.

    ``batch``: ``{"audio": [B, T]}`` (numpy or tensors), optionally with
    ``"mel" [B, n_mels, T // hop]`` and, when ``cfg.precompute_embeddings``,
    ``"speaker"`` and ``"emotion"``.  ``remat`` recomputes the generator's
    forward in its backward (``torch.utils.checkpoint``).  ``multi_steps >
    1``: ``batch`` has a leading ``[multi_steps]`` axis, the steps run in
    turn and the metrics are the window's means.  ``sample_fn``
    (:func:`hifigan_tpu_torch.train.device_data.make_device_sampler`): the
    step takes a ``torch.Generator`` in place of a batch, or a seed for one
    on the model's device, and draws each step's audio with it.  Metrics
    are 0-dim fp32 tensors on the device (reading one waits for the step).
    ``grad_sync(optimiser)``, a keyword of the step, runs after each
    backward and before each of the two updates: the data-parallel step
    averages the gradients there
    (:func:`hifigan_tpu_torch.parallel.make_sharded_train_step`)."""
    w = cfg.loss_weights

    def generate(vocoder, mel, batch):
        if cfg.precompute_embeddings:
            out = vocoder(mel, batch["speaker"], batch["emotion"], step=grc_step_reference)
        else:
            out = vocoder(mel, step=grc_step_reference)
        return out["waveform"][:, 0, :]

    def one_step(state: GanTrainState, batch: dict, grad_sync) -> dict:
        voc, discs = state.vocoder, state.discriminators
        batch = _as_batch(batch, next(voc.parameters()).device)
        mel, real = _mel_and_real(batch, cfg)
        if remat:
            fake = checkpoint(generate, voc, mel, batch, use_reentrant=False)
        else:
            fake = generate(voc, mel, batch)

        d_loss = discriminator_phase(state, real, fake, w, grad_sync)
        # generator phase, against the updated discriminators
        total, metrics = generator_losses(discs, real, fake, audio_to_mel(fake, cfg), mel, w, deep_feature_matching)
        state.gen_opt.zero_grad()
        total.backward()
        if grad_sync is not None:
            grad_sync(state.gen_opt)
        state.gen_opt.step()
        state.step += 1
        return {"generator_loss": total.detach(), "discriminator_loss": d_loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}}

    def batches(state: GanTrainState, batch) -> list[dict]:
        """The ``multi_steps`` batches of one call."""
        if sample_fn is not None:
            if not isinstance(batch, torch.Generator):
                batch = torch.Generator(next(state.vocoder.parameters()).device).manual_seed(int(batch))
            return [{"audio": sample_fn(batch)} for _ in range(multi_steps)]
        if multi_steps == 1:
            return [batch]
        return [{k: v[i] for k, v in batch.items()} for i in range(multi_steps)]

    def step(state: GanTrainState, batch, *, grad_sync: Optional[Callable] = None) -> tuple[GanTrainState, dict]:
        window = [one_step(state, b, grad_sync) for b in batches(state, batch)]
        if len(window) == 1:
            return state, window[0]
        return state, {k: torch.stack([m[k] for m in window]).mean() for k in window[0]}

    return step


def make_eval_step(cfg: TrainConfig) -> Callable:
    """``step(vocoder, batch) → {"waveform": [B, 1, T], "mel_l1"}`` under
    ``no_grad``, on the vocoder's default path (the GRC-step kernel on the
    card)."""

    @torch.no_grad()
    def step(vocoder, batch: dict) -> dict:
        batch = _as_batch(batch, next(vocoder.parameters()).device)
        mel, _ = _mel_and_real(batch, cfg)
        if cfg.precompute_embeddings:
            out = vocoder(mel, batch["speaker"], batch["emotion"])
        else:
            out = vocoder(mel)
        return {"waveform": out["waveform"], "mel_l1": mel_l1_loss(audio_to_mel(out["waveform"][:, 0, :], cfg), mel)}

    return step
