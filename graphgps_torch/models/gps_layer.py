"""The GPS layer on the main path: CustomGatedGCN local ∥ Transformer
global, BatchNorm, evaluation (counterpart of
``graphgps_tpu/models/gps_layer.py`` ``GPSLayer`` :37-531 on its merged
path).

Per layer, three kernels: the front (GatedGCN core + attention + residual),
the edge tail, and the combine+FFN; then the final BatchNorm and the padded
node slots zeroed. Weights are held in the kernels' (in, out) layout, with
their flax counterparts: ``w_front``/``b_front`` the joint
``[A|D|E|B|Wq|Wk|Wv]`` (``GatedGCNLayer_0/Dense_{0,3,4,1}`` and
``qkv_kernel``/``qkv_bias``), ``local`` (``GatedGCNLayer_0``),
``w_out``/``b_out`` (``out_kernel``/``out_bias``), ``norm_attn``
(``Norm_0``), ``w_ffn1``.. ``b_ffn2`` (``Dense_0``/``Dense_1``),
``norm_out`` (``Norm_1``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import fused_combine_ffn
from .common import MaskedBatchNorm, dense_params
from .local_gnn import FrontPack, GatedGCNLayer


class GPSLayer(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, act: str = "relu",
                 eps: float = 1e-5):
        super().__init__()
        if dim_h % num_heads:
            raise ValueError(f"dim_h={dim_h} is not divisible by "
                             f"num_heads={num_heads}")
        self.dim_h = dim_h
        self.num_heads = num_heads
        self.act = act
        self.eps = eps
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

    def front_pack(self) -> FrontPack:
        return FrontPack(w_front=self.w_front, b_front=self.b_front,
                         w_out=self.w_out, b_out=self.b_out,
                         ca=self.norm_attn.running_mean, H=self.num_heads,
                         scale=1.0 / float(self.dim_h // self.num_heads) ** 0.5)

    def combine_args(self, x_tail: tuple, s_attn) -> tuple:
        """The arguments of :func:`fused_combine_ffn`, from the local
        layer's x-tail arguments and the front's ``s_attn``."""
        mu_a, var_a, ga_a, be_a = self.norm_attn()
        return (*x_tail, s_attn, mu_a, torch.rsqrt(var_a + self.eps), ga_a,
                be_a, self.w_ffn1, self.b_ffn1, self.w_ffn2, self.b_ffn2, 0,
                0.0, self.act)

    def forward(self, batch: GraphBatch, x, e):
        if self.training:
            raise NotImplementedError(
                "GPSLayer training is not ported yet (ROADMAP Queue 1 "
                "items 8-9)")
        x_tail, s_attn, e = self.local(batch, x, e, self.front_pack())
        h = self.norm_out(fused_combine_ffn(*self.combine_args(x_tail, s_attn)))
        # zero padded slots so they never leak into aggregations
        h = torch.where(batch.node_mask[:, None], h, 0.0)
        return h, e
