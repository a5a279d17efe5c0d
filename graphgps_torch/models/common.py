"""Shared model building blocks: activations, masked BatchNorm, flax's
LayerNorm and the MLP.

Counterpart of ``graphgps_tpu/models/common.py`` (acts :18-33,
``MaskedBatchNorm`` :80-153, ``MLP`` :187-205) and of flax's
``nn.LayerNorm``. The activations are the kernels' own
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
    """BatchNorm over the real rows of a padded tensor (counterpart of
    ``graphgps_tpu/models/common.py:80-153`` ``MaskedBatchNorm``).

    Holds ``weight``/``bias`` (flax ``scale``/``bias``) and the running
    ``running_mean``/``running_var`` (flax ``mean``/``var``; the var is the
    biased one). In evaluation it uses the running statistics. In training
    it uses the batch's: from given moment sums ``moments=(sy, syy, cnt, c)``
    (Σm(v−c), Σm(v−c)², the row count, the shift c a kernel used), or from a
    masked single-pass reduction shifted by the running mean (c stops the
    gradient): ``mean = E[y] + c``, ``var = max(E[y²] − E[y]², 0)``,
    ``cnt = max(Σ mask, 1)``; both differentiate through ``mean``/``var``.
    Training then updates the running statistics as ``0.9·old + 0.1·batch``
    (flax momentum 0.9, torch's 0.1) out of place: the buffers are replaced,
    never written, so a kernel that took the old running mean as its moment
    shift still holds it in its backward. With ``stats_only`` it returns
    ``(mean, var, weight, bias)`` for a fused kernel to apply;
    :meth:`normalize` applies such a norm all the same (the plain tails of
    the unmerged layer).
    """

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5, stats_only: bool = False):
        super().__init__()
        self.eps = eps
        self.stats_only = stats_only
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def batch_stats(self, x=None, mask=None, moments=None):
        """(mean, var) of the batch, differentiable."""
        if moments is not None:
            sy, syy, cnt, c = moments
            ey = sy.reshape(-1) / cnt
            ey2 = syy.reshape(-1) / cnt
        else:
            c = self.running_mean.detach()
            y = x - c
            m = mask.to(x.dtype)[:, None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mom = (torch.cat([y, y * y], dim=-1) * m).sum(0) / cnt
            d = x.shape[-1]
            ey, ey2 = mom[:d], mom[d:]
        mean = ey + c
        var = torch.maximum(ey2 - ey * ey, torch.zeros_like(ey))
        return mean, var

    def stats(self, x=None, mask=None, moments=None):
        """(mean, var, weight, bias) in force; training updates the running
        statistics."""
        if self.training:
            mean, var = self.batch_stats(x, mask, moments)
            mo = self.momentum
            with torch.no_grad():
                self.running_mean = mo * self.running_mean + (1 - mo) * mean
                self.running_var = mo * self.running_var + (1 - mo) * var
        else:
            mean, var = self.running_mean, self.running_var
        return mean, var, self.weight, self.bias

    def normalize(self, x, mask=None, moments=None):
        """The norm applied to ``x``, whatever ``stats_only`` says."""
        mean, var, weight, bias = self.stats(x, mask, moments)
        return (x - mean) * torch.rsqrt(var + self.eps) * weight + bias

    def forward(self, x=None, mask=None, moments=None):
        if self.stats_only:
            return self.stats(x, mask, moments)
        return self.normalize(x, mask, moments)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` as the JAX package uses it (flax 0.12): over the
    last axis, eps 1e-6 (torch's default is 1e-5), and the fast variance
    ``max(E[x²] − E[x]², 0)`` (``use_fast_variance=True``), not the centred
    one; ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias``. Parameters
    ``weight`` and ``bias`` (flax ``scale`` and ``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class MLP(nn.Module):
    """``num_layers`` Linears (``layers``; flax ``Dense_<i>``) with the
    activation between them, and after the last with ``with_final_act``;
    the hidden ones are ``hidden_dim`` wide."""

    def __init__(self, dim_in: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, act: str = "relu",
                 with_final_act: bool = False):
        super().__init__()
        dims = [dim_in] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.act = get_act(act)
        self.with_final_act = with_final_act

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1 or self.with_final_act:
                x = self.act(x)
        return x
