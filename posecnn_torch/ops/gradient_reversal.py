"""Gradient reversal for domain adaptation (Ganin & Lempitsky).

Counterpart of `posecnn_tpu/ops/gradient_reversal.py:18-30` (the
reference's `Gradientreversal` op): the identity forward, −λ·g backward,
as a `torch.autograd.Function`.
"""

from __future__ import annotations

import torch


class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambda_ * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    return GradientReversal.apply(x, lambda_)
