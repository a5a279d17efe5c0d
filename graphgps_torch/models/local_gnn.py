"""The local message-passing layers: GatedGCN (counterpart of
``graphgps_tpu/models/local_gnn.py`` ``GatedGCNLayer`` :74-329: the merged
dispatch :106-149, the standalone fused core :150-184, the long-graph rung
:185-233, the fused tails :258-316 and the plain tails :318-329), GINE
(``GINELayer`` :333-368 with ``_es_pe_scale`` :38-46) and GCN (``GCNLayer``
:386-403); GINE and GCN at the end of this file, in PyTorch ops (neither
reaches a Pallas kernel in JAX).

Two paths. On the merged path (:meth:`GatedGCNLayer.forward`) the front
kernel takes the node projections A, D, E, B (flax ``Dense_0``,
``Dense_3``, ``Dense_4``, ``Dense_1``) as the columns ``[A|D|E|B]`` of one
``(d, 7d)`` matrix, followed by the GPS layer's ``[Wq|Wk|Wv]``; the GPS
layer holds that joint weight (``w_front``) and hands it over in a
:class:`FrontPack`. This layer holds the edge projection C (``Dense_2``:
``w_c``/``b_c``, (in, out)) and the node/edge BatchNorms (flax
``Norm_0``/``Norm_1``). In training the norms take their statistics from
the front's moment partials, with the running means the front used as
shifts. The x-tail is handed back unapplied for the combine+FFN kernel, and
the edge tail is applied here.

On the unmerged path (:meth:`GatedGCNLayer.unmerged`) the layer holds
``[A|D|E|B]`` itself (``w_node``/``b_node``) at widths that are no multiple
of 128, and at a multiple of 128 takes it from the GPS layer's joint
weight; it runs the standalone core kernel ``fused_gatedgcn``. With ``defer`` the
tails are the merged path's (norm statistics from the kernel's moment
partials, the edge tail through ``fused_pre_tail``, the x-tail handed back);
without it both tails are plain PyTorch: ``x + act(bn(x_new))`` with the
norms' own masked statistics in training and no dropout (the JAX layer takes
its fused tails whenever dropout is on).

The unmerged path has a second rung for long graphs. The core kernel holds
a graph's receivers in shared memory (five arrays of N x 64 floats in its
backward), so it takes graphs of at most ``gatedgcn.MAX_NODES`` node slots;
beyond that the five Linears are ``torch.matmul`` products here (the JAX
package computes them outside its kernel too), ``fused_edge_gate`` does the
gathers, the gate and the aggregation, and ``x_new = A x + num / (den +
1e-6)`` follows in PyTorch. The rule is this card's shared memory, not the
TPU's VMEM arithmetic (``edge_gate_eligible``). The edge gate walks the
batch's edge orders (``GraphBatch.edge_gate_orders``, built once per batch
and shared by every layer), and returns no moment partials: on this rung
the norms take their own masked statistics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import (fused_edge_gate, fused_gatedgcn, fused_gps_front,
                           fused_pre_tail)
from ..ops.kernels.gatedgcn import MAX_NODES as CORE_MAX_NODES
from ..ops.kernels.common import exact_dropout
from ..ops.segment import gather, segment_sum
from .common import MLP, MaskedBatchNorm, dense_params, get_act


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

    def __init__(self, dim: int, act: str = "relu", eps: float = 1e-5,
                 own_node_proj: bool = False):
        super().__init__()
        self.dim = dim
        self.act = act
        self.eps = eps
        if own_node_proj:
            # A, D, E, B side by side, each drawn as a (d, d) Dense
            ws, bs = zip(*(dense_params(dim, dim) for _ in range(4)))
            self.w_node = nn.Parameter(torch.cat(ws, dim=1).detach())
            self.b_node = nn.Parameter(torch.cat(bs).detach())
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
                       moments=None, mask=None) -> tuple:
        """The arguments of :func:`fused_pre_tail`:
        ``e + drop(act(bn_e(gate)))``; the training statistics from a
        kernel's ``moments`` or, with ``mask``, from ``gate`` itself."""
        me, ve, sce, bie = self.norm_e(gate, mask, moments)
        return (e, gate, me, torch.rsqrt(ve + self.eps), sce, bie, seed, rate,
                self.act)

    def x_tail_args(self, x, x_new, moments=None, mask=None) -> tuple:
        """The x-tail ``x + drop(act(bn_x(x_new)))`` as (x_in, v, mu, inv,
        gamma, beta), for the combine+FFN kernel to apply; statistics as in
        :meth:`edge_tail_args`."""
        mx, vx, scx, bix = self.norm_x(x_new, mask, moments)
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

    def node_proj(self, node=None):
        """``node`` (the ``[A|D|E|B]`` weight and bias the GPS layer hands
        over, from its joint front weight), or this layer's own (built with
        ``own_node_proj``)."""
        return node if node is not None else (self.w_node, self.b_node)

    def core_args(self, batch: GraphBatch, x, e, node=None) -> tuple:
        """The arguments of :func:`fused_gatedgcn` for this layer, with the
        node projection of :meth:`node_proj`."""
        B, N, E, d = (batch.num_graphs, batch.max_nodes, batch.edge_block,
                      self.dim)
        s_loc, r_loc, emask, nmask = batch.front_index
        return (x.reshape(B, N, d), e.reshape(B, E, d), s_loc, r_loc, emask,
                nmask, self.norm_x.running_mean, self.norm_e.running_mean,
                *self.node_proj(node), self.w_c, self.b_c)

    def edge_gate_args(self, batch: GraphBatch, x, e, node=None) -> tuple:
        """(A x (B*N, d), the arguments of :func:`fused_edge_gate`): the five
        Linears as ``torch.matmul`` products from ``[A|D|E|B]``
        (:meth:`node_proj`) and C."""
        B, N, E, d = (batch.num_graphs, batch.max_nodes, batch.edge_block,
                      self.dim)
        s_loc, r_loc, emask, _ = batch.front_index
        w, b = self.node_proj(node)
        ax = x @ w[:, :d] + b[:d]
        pd = x @ w[:, d:2 * d] + b[d:2 * d]
        peb = x @ w[:, 2 * d:] + b[2 * d:]
        ce = e @ self.w_c + self.b_c
        return ax, (pd.reshape(B, N, d), peb.reshape(B, N, 2 * d),
                    ce.reshape(B, E, d), s_loc, r_loc, emask)

    def core(self, batch: GraphBatch, x, e, node=None):
        """The unmerged path's pre-norm outputs (x_new (B*N, d), gate
        (B*E, d), mom_x, mom_e): through the core kernel, with the norms'
        moment sums in training; on long graphs through the Linears and the
        edge gate, with no moments (the norms then reduce x_new and gate
        themselves). ``node``: as :meth:`node_proj`."""
        d = self.dim
        if batch.max_nodes > CORE_MAX_NODES:
            ax, args = self.edge_gate_args(batch, x, e, node)
            gate, nd = fused_edge_gate(*args, orders=batch.edge_gate_orders)
            nd = nd.reshape(-1, 2 * d)
            return (ax + nd[:, :d] / (nd[:, d:] + 1e-6), gate.reshape(-1, d),
                    None, None)
        args = self.core_args(batch, x, e, node)
        cx, cg = args[6], args[7]
        xo, gate, px, pg = fused_gatedgcn(*args)
        mom_x = mom_e = None
        if self.training:
            cnt_n, cnt_e = batch.real_counts
            mom_x = (px[0, :d], px[0, d:], cnt_n, cx)
            mom_e = (pg[0, :d], pg[0, d:], cnt_e, cg)
        return xo.reshape(-1, d), gate.reshape(-1, d), mom_x, mom_e

    def unmerged(self, batch: GraphBatch, x, e, defer: bool,
                 seed_e: int = 0, rate: float = 0.0, node=None):
        """:meth:`core` (with ``node``) and the tails. With ``defer``
        returns (x-tail arguments, e_new); otherwise (x_new, e_new), both
        tails applied in plain PyTorch (``rate`` must be 0 then)."""
        xo, gate, mom_x, mom_e = self.core(batch, x, e, node)
        if not defer:
            if rate > 0.0:
                raise ValueError("the plain tails carry no dropout")
            act = get_act(self.act)
            return (x + act(self.norm_x.normalize(xo, batch.node_mask)),
                    e + act(self.norm_e.normalize(gate, batch.edge_mask)))
        e_new = fused_pre_tail(*self.edge_tail_args(
            e, gate, seed_e, rate, mom_e, batch.edge_mask))
        return self.x_tail_args(x, xo, mom_x, batch.node_mask), e_new


def seg_kw(batch: GraphBatch) -> dict:
    """The batch's layout, which picks the segment ops' rungs (JAX's
    ``_seg_kw``): the shapes alone, nothing read from the device."""
    return dict(edge_block=batch.edge_block, max_nodes=batch.max_nodes)


class GINELayer(nn.Module):
    """GINEConv: per edge ``m = relu(x[s] + e)`` (``relu(x[s])`` without
    edge features), scaled by ``sigmoid(MLP(‖pe[s] − pe[r]‖²))`` where the
    batch holds ``pe_EquivStableLapPE`` and the layer was built with
    ``equivstable_pe``; ``h = (1 + eps)·x + Σ_receivers m``, then a 2-layer
    MLP (``mlp``). With ``wrap_norm_act`` (the ``custom_gnn`` form) ``h``
    then takes the norm (a MaskedBatchNorm with ``batch_norm``, else none),
    the activation, flax ``nn.Dropout``'s exact-rate dropout (site 0 of
    ``seed``) and the residual. The edge features pass through unchanged.

    flax names: ``eps``; ``MLP_0`` the ES scale's MLP (``es_mlp``) when
    built with ``equivstable_pe``, then the update MLP (``MLP_1``, else
    ``MLP_0``); in the wrapped form ``Norm_0`` (``norm``)."""

    def __init__(self, dim: int, act: str = "relu",
                 equivstable_pe: bool = False, wrap_norm_act: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0,
                 residual: bool = True, norm_eps: float = 1e-5):
        super().__init__()
        self.act = act
        self.eps = nn.Parameter(torch.zeros(()))
        self.es_mlp = (MLP(1, dim, 1, num_layers=2, act="relu")
                       if equivstable_pe else None)
        self.mlp = MLP(dim, dim, dim, num_layers=2, act=act)
        self.wrap_norm_act = wrap_norm_act
        self.norm = (MaskedBatchNorm(dim, norm_eps)
                     if wrap_norm_act and batch_norm else None)
        self.dropout = dropout
        self.residual = residual

    def forward(self, batch: GraphBatch, x, e, seed=0):
        kw = seg_kw(batch)
        xs = gather(x, batch.senders, **kw)
        m = torch.relu(xs + e) if e is not None else torch.relu(xs)
        pe = batch.pe.get("pe_EquivStableLapPE")
        if self.es_mlp is not None and pe is not None:
            diff = (gather(pe, batch.senders, **kw)
                    - gather(pe, batch.receivers, **kw))
            m = m * torch.sigmoid(self.es_mlp((diff * diff).sum(
                -1, keepdim=True)))
        agg = segment_sum(m, batch.receivers, batch.num_node_slots,
                          mask=batch.edge_mask, **kw)
        h = self.mlp((1.0 + self.eps) * x + agg)
        if self.wrap_norm_act:
            if self.norm is not None:
                h = self.norm(h, batch.node_mask)
            rate = self.dropout if self.training else 0.0
            h = exact_dropout(get_act(self.act)(h), seed, 0, rate)
            if self.residual:
                h = x + h
        return h, e


class GCNLayer(nn.Module):
    """GCN with the symmetric degree norm and an implicit self-loop:
    ``h = x W + b``, ``deg = (real in-edges) + 1``, and each node gets
    ``sum over its in-edges of h[s] / sqrt(deg[s] deg[r]) + h / deg``.
    ``w``/``b`` are flax's ``Dense_0`` in the (in, out) layout. The edge
    features pass through untouched."""

    def __init__(self, dim: int):
        super().__init__()
        self.w, self.b = dense_params(dim, dim)

    def forward(self, batch: GraphBatch, x, e):
        s, r = batch.senders, batch.receivers
        h = x @ self.w + self.b
        S = batch.num_node_slots
        kw = seg_kw(batch)
        deg = segment_sum(batch.edge_mask.to(h.dtype), r, S, **kw) + 1.0
        dinv = torch.rsqrt(deg)
        sl, rl = s.long(), r.long()
        msgs = gather(h, s, **kw) * dinv[sl, None] * dinv[rl, None]
        agg = segment_sum(msgs, r, S, mask=batch.edge_mask, **kw)
        return agg + h * (dinv * dinv)[:, None], e
