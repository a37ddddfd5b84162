"""GAN losses: LSGAN or hinge adversarial, feature matching, mel L1.

Counterpart of ``hifigan_tpu/train/losses.py``.  Every reduction is in
fp32; the real side of feature matching is detached, as the JAX package's
``stop_gradient``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossWeights:
    """Feature matching 10, mel 45, adversarial 1, LSGAN (the reference
    trainer's profile); ``LossWeights(feature_matching=45.0,
    adversarial_type="hinge")`` is the alternative trainer's."""

    feature_matching: float = 10.0
    mel: float = 45.0
    adversarial: float = 1.0
    multi_res_stft: float = 0.0  # the optional multi-resolution STFT loss
    adversarial_type: str = "lsgan"  # "lsgan" | "hinge"


def _mse_to(outputs, target: float) -> torch.Tensor:
    return sum(((o.float() - target).square().mean() for o in outputs))


def generator_adversarial_loss(fake_outputs, kind: str = "lsgan") -> torch.Tensor:
    """LSGAN: Σ heads MSE(fake, 1); hinge: Σ heads −mean(fake)."""
    if kind == "hinge":
        return sum((-o.float().mean() for o in fake_outputs))
    return _mse_to(fake_outputs, 1.0)


def discriminator_loss(real_outputs, fake_outputs, kind: str = "lsgan") -> torch.Tensor:
    """LSGAN: Σ MSE(real, 1) + MSE(fake, 0); hinge: Σ mean(relu(1 − real)) +
    mean(relu(1 + fake))."""
    if kind == "hinge":
        return sum((torch.relu(1.0 - r.float()).mean() + torch.relu(1.0 + f.float()).mean()
                    for r, f in zip(real_outputs, fake_outputs)))
    return _mse_to(real_outputs, 1.0) + _mse_to(fake_outputs, 0.0)


def feature_matching_loss(real, fake) -> torch.Tensor:
    """L1 between fake and detached real activations: per head's final
    output (lists of tensors), or per layer (lists of lists, deep FM)."""
    total = 0.0
    for r, f in zip(real, fake):
        pairs = zip(r, f) if isinstance(r, (list, tuple)) else [(r, f)]
        for ri, fi in pairs:
            total = total + (fi.float() - ri.detach().float()).abs().mean()
    return total


def mel_l1_loss(generated_mel: torch.Tensor, target_mel: torch.Tensor) -> torch.Tensor:
    return (generated_mel.float() - target_mel.float()).abs().mean()
