"""The GPS layer on the main path: CustomGatedGCN local ∥ Transformer
global, BatchNorm (counterpart of ``graphgps_tpu/models/gps_layer.py``
``GPSLayer`` :37-531 on its merged path, :173-215 and :471-495).

Per layer, three kernels: the front (GatedGCN core + attention + dropout and
residual), the edge tail, and the combine+FFN; then the final BatchNorm and
the padded node slots zeroed. In training each of the three draws its
dropout from a seed of its own, and the attention branch's norm takes its
statistics from the front's moment partials. Weights are held in the
kernels' (in, out) layout, with their flax counterparts:
``w_front``/``b_front`` the joint ``[A|D|E|B|Wq|Wk|Wv]``
(``GatedGCNLayer_0/Dense_{0,3,4,1}`` and ``qkv_kernel``/``qkv_bias``),
``local`` (``GatedGCNLayer_0``), ``w_out``/``b_out``
(``out_kernel``/``out_bias``), ``norm_attn`` (``Norm_0``), ``w_ffn1``..
``b_ffn2`` (``Dense_0``/``Dense_1``), ``norm_out`` (``Norm_1``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import fused_combine_ffn
from .common import MaskedBatchNorm, dense_params
from .local_gnn import FrontPack, GatedGCNLayer

# dropout seeds per layer and step: front, edge tail, combine+FFN
SEEDS_PER_LAYER = 3


def draw_seeds(gen: Optional[torch.Generator], n: int):
    """``n`` dropout seeds from the host generator ``gen``."""
    if gen is None:
        raise ValueError("training with dropout needs a dropout generator")
    return torch.randint(0, 2 ** 31, (n,), generator=gen).tolist()


class GPSLayer(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, act: str = "relu",
                 eps: float = 1e-5, dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        if dim_h % num_heads:
            raise ValueError(f"dim_h={dim_h} is not divisible by "
                             f"num_heads={num_heads}")
        self.dim_h = dim_h
        self.num_heads = num_heads
        self.act = act
        self.eps = eps
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        # A, D, E, B, Wq, Wk, Wv side by side, each drawn as a (d, d) Dense
        ws, bs = zip(*(dense_params(dim_h, dim_h) for _ in range(7)))
        self.w_front = nn.Parameter(torch.cat(ws, dim=1).detach())
        self.b_front = nn.Parameter(torch.cat(bs).detach())
        self.local = GatedGCNLayer(dim_h, act, eps)
        self.w_out, self.b_out = dense_params(dim_h, dim_h)
        self.norm_attn = MaskedBatchNorm(dim_h, eps, stats_only=True)
        self.w_ffn1, self.b_ffn1 = dense_params(dim_h, 2 * dim_h)
        self.w_ffn2, self.b_ffn2 = dense_params(2 * dim_h, dim_h)
        self.norm_out = MaskedBatchNorm(dim_h, eps)

    @property
    def rates(self):
        """(dropout, attn_dropout) in force: both 0 in evaluation."""
        if not self.training:
            return 0.0, 0.0
        return self.dropout, self.attn_dropout

    def front_pack(self, seed: int = 0) -> FrontPack:
        drop, attn = self.rates
        return FrontPack(w_front=self.w_front, b_front=self.b_front,
                         w_out=self.w_out, b_out=self.b_out,
                         ca=self.norm_attn.running_mean, H=self.num_heads,
                         scale=1.0 / float(self.dim_h // self.num_heads) ** 0.5,
                         seed=seed, attn_rate=attn, drop_rate=drop)

    def combine_args(self, x_tail: tuple, s_attn, seed: int = 0,
                     moments=None) -> tuple:
        """The arguments of :func:`fused_combine_ffn`, from the local
        layer's x-tail arguments and the front's ``s_attn``."""
        mu_a, var_a, ga_a, be_a = self.norm_attn(moments=moments)
        return (*x_tail, s_attn, mu_a, torch.rsqrt(var_a + self.eps), ga_a,
                be_a, self.w_ffn1, self.b_ffn1, self.w_ffn2, self.b_ffn2, seed,
                self.rates[0], self.act)

    def forward(self, batch: GraphBatch, x, e,
                gen: Optional[torch.Generator] = None):
        """``gen`` draws the layer's dropout seeds in training."""
        seeds = [0] * SEEDS_PER_LAYER
        if any(self.rates):
            seeds = draw_seeds(gen, SEEDS_PER_LAYER)
        front = self.front_pack(seeds[0])
        x_tail, s_attn, e, pa = self.local(batch, x, e, front, seeds[1])
        mom_a = None
        if self.training:
            d = self.dim_h
            mom_a = (pa[0, :d], pa[0, d:], batch.real_counts[0], front.ca)
        h = fused_combine_ffn(*self.combine_args(x_tail, s_attn, seeds[2],
                                                 mom_a))
        h = self.norm_out(h, batch.node_mask)
        # zero padded slots so they never leak into aggregations
        h = torch.where(batch.node_mask[:, None], h, 0.0)
        return h, e
