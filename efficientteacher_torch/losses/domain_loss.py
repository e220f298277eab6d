"""Domain-adaptation losses over the gradient-reversed discriminator maps
(counterpart of `efficientteacher_tpu/losses/domain_loss.py`; reference
models/loss/loss.py:312-421): a 2-class softmax focal loss (gamma 2),
source images labelled 0 and target images 1, each times 0.5. The maps are
the port's NCHW (B, 2, H, W)."""

from __future__ import annotations

from typing import Sequence

import torch

from .common import batch_mean


def domain_focal_loss(logits: torch.Tensor, target_cls: int,
                      gamma: float = 2.0) -> torch.Tensor:
    """Softmax focal loss over (N, 2) logits, mean."""
    logp = torch.log_softmax(logits, -1)[:, target_cls]
    return batch_mean(-((1.0 - logp.exp()) ** gamma) * logp)


def _flatten(features: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([f.permute(0, 2, 3, 1).reshape(-1, 2) for f in features])


def domain_loss(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """Source-domain alignment loss (label 0)."""
    return 0.5 * domain_focal_loss(_flatten(features), 0)


def target_loss(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """Target-domain alignment loss (label 1)."""
    return 0.5 * domain_focal_loss(_flatten(features), 1)
