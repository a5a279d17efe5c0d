"""GatedGCN local layer on the merged layer front (counterpart of
``graphgps_tpu/models/local_gnn.py`` ``GatedGCNLayer`` :74-329: the merged
dispatch :106-149 and the fused edge tail :258-308).

The front kernel takes the node projections A, D, E, B (flax ``Dense_0``,
``Dense_3``, ``Dense_4``, ``Dense_1``) as the columns ``[A|D|E|B]`` of one
``(d, 7d)`` matrix, followed by the GPS layer's ``[Wq|Wk|Wv]``; the GPS
layer holds that joint weight (``w_front``) and hands it over in a
:class:`FrontPack`. This layer holds the edge projection C (``Dense_2``:
``w_c``/``b_c``, (in, out)) and the node/edge BatchNorms (flax
``Norm_0``/``Norm_1``). In training the norms take their statistics from
the front's moment partials, with the running means the front used as
shifts. The x-tail is handed back unapplied for the combine+FFN kernel, and
the edge tail is applied here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import fused_gps_front, fused_pre_tail
from .common import MaskedBatchNorm, dense_params


class FrontPack(NamedTuple):
    """The GPS layer's share of the front's arguments, (in, out) layout."""

    w_front: torch.Tensor  # (d, 7d) = [A|D|E|B|Wq|Wk|Wv]
    b_front: torch.Tensor  # (7d,)
    w_out: torch.Tensor    # (d, d) attention out-projection
    b_out: torch.Tensor    # (d,)
    ca: torch.Tensor       # (d,) moment shift of s_attn (its norm's running mean)
    H: int
    scale: float
    seed: int              # dropout seed of the front (both its sites)
    attn_rate: float       # attention-probability dropout
    drop_rate: float       # dropout of the attention branch's output


class GatedGCNLayer(nn.Module):
    """Residual gated graph convnet with BatchNorm, updating node and edge
    features."""

    def __init__(self, dim: int, act: str = "relu", eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.act = act
        self.eps = eps
        self.w_c, self.b_c = dense_params(dim, dim)
        self.norm_x = MaskedBatchNorm(dim, eps, stats_only=True)
        self.norm_e = MaskedBatchNorm(dim, eps, stats_only=True)

    def front_args(self, batch: GraphBatch, x, e, front: FrontPack) -> tuple:
        """The arguments of :func:`fused_gps_front` for this layer."""
        B, N, E, d = (batch.num_graphs, batch.max_nodes, batch.edge_block,
                      self.dim)
        s_loc, r_loc, emask, nmask = batch.front_index
        return (x.reshape(B, N, d), e.reshape(B, E, d), s_loc, r_loc, emask,
                nmask, self.norm_x.running_mean, self.norm_e.running_mean,
                front.ca, front.w_front, front.b_front, self.w_c, self.b_c,
                front.w_out, front.b_out, front.seed, front.H, front.scale,
                front.attn_rate, front.drop_rate)

    def edge_tail_args(self, e, gate, seed: int = 0, rate: float = 0.0,
                       moments=None) -> tuple:
        """The arguments of :func:`fused_pre_tail`:
        ``e + drop(act(bn_e(gate)))``."""
        me, ve, sce, bie = self.norm_e(moments=moments)
        return (e, gate, me, torch.rsqrt(ve + self.eps), sce, bie, seed, rate,
                self.act)

    def x_tail_args(self, x, x_new, moments=None) -> tuple:
        """The x-tail ``x + drop(act(bn_x(x_new)))`` as (x_in, v, mu, inv,
        gamma, beta), for the combine+FFN kernel to apply."""
        mx, vx, scx, bix = self.norm_x(moments=moments)
        return (x, x_new, mx, torch.rsqrt(vx + self.eps), scx, bix)

    def forward(self, batch: GraphBatch, x, e, front: FrontPack,
                seed_e: int = 0):
        """Returns (x-tail arguments, s_attn (B*N, d), e_new (B*E, d),
        pa (1, 2d) the moment partials of s_attn)."""
        args = self.front_args(batch, x, e, front)
        cx, cg = args[6], args[7]
        xo, gate, sa, px, pg, pa = fused_gps_front(*args)
        d = self.dim
        mom_x = mom_e = None
        if self.training:
            # the norms' batch statistics from the kernel's moment partials
            # (evaluation applies the running statistics and leaves them)
            cnt_n, cnt_e = batch.real_counts
            mom_x = (px[0, :d], px[0, d:], cnt_n, cx)
            mom_e = (pg[0, :d], pg[0, d:], cnt_e, cg)
        # the edge tail's dropout is the layer's, as the front's output's
        e_new = fused_pre_tail(*self.edge_tail_args(
            e, gate.reshape(-1, d), seed_e, front.drop_rate, mom_e))
        return (self.x_tail_args(x, xo.reshape(-1, d), mom_x),
                sa.reshape(-1, d), e_new, pa)
