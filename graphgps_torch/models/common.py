"""Shared model building blocks: activations and masked BatchNorm.

Counterpart of ``graphgps_tpu/models/common.py`` (acts :18-33,
``MaskedBatchNorm`` :80-153). The activations are the kernels' own
(``ops/kernels/common.py``; gelu is the exact-erf form). The JAX ``Embed``'s
one-hot gradient trick served the TPU's matrix unit; here an embedding is a
plain ``nn.Embedding`` lookup.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.kernels.common import act_fn as get_act  # noqa: F401


def dense_params(d_in: int, d_out: int):
    """A Dense layer's (weight (d_in, d_out), bias (d_out,)) in the kernels'
    (in, out) layout -- flax's -- drawn as ``nn.Linear`` draws its own:
    U(±1/√d_in)."""
    bound = 1.0 / math.sqrt(d_in)
    return (nn.Parameter(torch.empty(d_in, d_out).uniform_(-bound, bound)),
            nn.Parameter(torch.empty(d_out).uniform_(-bound, bound)))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the real rows of a padded tensor, evaluation only.

    Holds ``weight``/``bias`` (flax ``scale``/``bias``) and the running
    ``running_mean``/``running_var`` (flax ``mean``/``var``; the var is the
    biased one). In evaluation it normalizes with the running statistics;
    with ``stats_only`` it returns ``(mean, var, weight, bias)`` for a fused
    kernel to apply. Training-mode statistics come with the training slice.
    """

    def __init__(self, dim: int, eps: float = 1e-5, stats_only: bool = False):
        super().__init__()
        self.eps = eps
        self.stats_only = stats_only
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x=None):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm in training mode is not ported yet "
                "(ROADMAP Queue 1 item 9)")
        mean, var = self.running_mean, self.running_var
        if self.stats_only:
            return mean, var, self.weight, self.bias
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
