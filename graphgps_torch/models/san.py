"""The SAN layer: attention over the real edges and, under ``full_graph``,
the complement graph's "fake" edges, then BatchNorm and the FFN
(counterparts of ``graphgps_tpu/models/san.py``: ``dense_adjacency`` :25-34,
``SANAttention`` :37-108, ``SANLayer`` :111-203).

The real-edge branch is sparse: per edge ``exp(clip(Σ k[s]·q[r]·E / √Dh,
±5))``, divided by γ + 1 under ``full_graph``, gathers and ``index_add_``
over the receivers (JAX ``segment_sum``; no kernel). The fake branch is dense
over the (B, H, N, N) pair grid of each graph with its own Q2/K2 and the
learned fake edge embedding through E2, scaled by γ/(γ + 1), masked to the
pairs of real nodes that are no edge and no self-pair. The JAX package
leaves both to XLA; here they are PyTorch ops.

The layer: attention → dropout (flax ``nn.Dropout``, the exact-rate rule)
→ O → residual, then the attention norm and the FFN. In training with
dropout on (or at a width that is a multiple of 128) the norm's statistics
come from ``MaskedBatchNorm`` in ``stats_only`` mode and the ``fused_bn_ffn``
kernel applies them and runs the FFN, the residual riding the normed tensor
and only the inner dropout on (the u8 rule); without BatchNorm the
``fused_ffn`` kernel runs the FFN the same way; otherwise the norm, the FFN
(its hidden units under the exact-rate rule) and the residual are PyTorch
ops. Then the last norm, and the padded rows zeroed. A layer draws two seeds
per training step with dropout: the attention output's and the FFN's.

Weights, in (in, out) layout with their flax names: ``attn.w_q``..``w_v``,
``attn.w_e``, ``attn.w_q2``/``w_k2``/``w_e2`` (``SANAttention_0``'s
``DenseGeneral`` Q, K, V, E, Q2, K2, E2, kernels (d, H, Dh) flattened to
(d, H·Dh), no bias), ``attn.fake_edge_emb``; ``w_o``/``b_o`` (``Dense_0``),
``w_ffn1``/``b_ffn1`` (``Dense_1``), ``w_ffn2``/``b_ffn2`` (``Dense_2``),
``norm1`` (``Norm_0``), ``norm2`` (``Norm_1``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import fused_bn_ffn, fused_ffn
from ..ops.kernels.common import exact_dropout
from .common import MaskedBatchNorm, dense_params, get_act
from .gps_layer import draw_seeds, tail_eligible

SEEDS_PER_LAYER = 2   # attention output, FFN


def dense_adjacency(batch: GraphBatch):
    """(B, N, N) bool: ``adj[b, i, j]`` where graph b has a real edge from
    its node i to its node j."""
    B, N = batch.num_graphs, batch.max_nodes
    s, r = batch.senders.long(), batch.receivers.long()
    flat = (s // N) * (N * N) + (s % N) * N + r % N
    adj = torch.zeros(B * N * N, dtype=torch.bool, device=s.device)
    adj[flat[batch.edge_mask]] = True
    return adj.reshape(B, N, N)


def _proj(d: int, out: int):
    """A bias-free ``DenseGeneral`` kernel (in, out), N(0, 1/in) as flax's
    lecun normal draws it (untruncated)."""
    return nn.Parameter(torch.randn(d, out) / math.sqrt(d))


class SANAttention(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, gamma: float,
                 full_graph: bool):
        super().__init__()
        if dim_h % num_heads:
            raise ValueError(f"dim_h={dim_h} is not divisible by "
                             f"num_heads={num_heads}")
        self.num_heads, self.gamma, self.full_graph = num_heads, gamma, \
            full_graph
        for name in ("q", "k", "v", "e"):
            setattr(self, f"w_{name}", _proj(dim_h, dim_h))
        if full_graph:
            for name in ("q2", "k2", "e2"):
                setattr(self, f"w_{name}", _proj(dim_h, dim_h))
            self.fake_edge_emb = nn.Parameter(torch.randn(dim_h))

    def forward(self, batch: GraphBatch, x, e):
        """x: (B·N, d) node rows, e: (B·E, d) edge rows → (B·N, d)."""
        S, d = x.shape
        H = self.num_heads
        Dh = d // H
        heads = lambda t: t.reshape(t.shape[0], H, Dh)  # noqa: E731
        q, k, v = heads(x @ self.w_q), heads(x @ self.w_k), heads(x @ self.w_v)
        eh = heads(e @ self.w_e)
        si, ri = batch.senders.long(), batch.receivers.long()
        g = self.gamma
        score = (k[si] * q[ri] * eh).sum(-1) / math.sqrt(Dh)      # (E, H)
        score = torch.exp(torch.clamp(score, -5.0, 5.0))
        if self.full_graph:
            score = score / (g + 1.0)
        score = score * batch.edge_mask[:, None]
        wv = x.new_zeros(S, H, Dh).index_add_(0, ri, v[si] * score[..., None])
        z = x.new_zeros(S, H).index_add_(0, ri, score)
        if self.full_graph:
            B, N = batch.num_graphs, batch.max_nodes
            q2 = (x @ self.w_q2).reshape(B, N, H, Dh)
            k2 = (x @ self.w_k2).reshape(B, N, H, Dh)
            e2 = (self.fake_edge_emb @ self.w_e2).reshape(H, Dh)
            s2 = torch.einsum("bjhd,hd,bihd->bhji", q2, e2, k2)
            s2 = torch.exp(torch.clamp(s2 / math.sqrt(Dh), -5.0, 5.0))
            s2 = s2 * (g / (g + 1.0))
            vmask = batch.dense_view(batch.node_mask)             # (B, N)
            eye = torch.eye(N, dtype=torch.bool, device=x.device)
            # fake_mask[b, j, i]: a message i → j where no real edge i → j
            # runs: ¬adj[b, i, j], the transpose (invisible on undirected
            # data; the reference fixture san_full has asymmetric edges)
            fake = (vmask[:, :, None] & vmask[:, None, :]
                    & ~dense_adjacency(batch).transpose(1, 2) & ~eye)
            s2 = s2 * fake[:, None]
            wv2 = torch.einsum("bhji,bihd->bjhd", s2,
                               v.reshape(B, N, H, Dh))
            wv = wv + wv2.reshape(S, H, Dh)
            z = z + s2.sum(-1).transpose(1, 2).reshape(S, H)
        return (wv / (z[..., None] + 1e-6)).reshape(S, d)


class SANLayer(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, gamma: float = 1e-5,
                 full_graph: bool = True, dropout: float = 0.0,
                 batch_norm: bool = True, residual: bool = True,
                 act: str = "relu", eps: float = 1e-5):
        super().__init__()
        self.dim_h, self.dropout, self.residual = dim_h, dropout, residual
        self.act, self.eps = act, eps
        self.attn = SANAttention(dim_h, num_heads, gamma, full_graph)
        self.w_o, self.b_o = dense_params(dim_h, dim_h)
        self.w_ffn1, self.b_ffn1 = dense_params(dim_h, 2 * dim_h)
        self.w_ffn2, self.b_ffn2 = dense_params(2 * dim_h, dim_h)
        self.norm1 = self.norm2 = None
        if batch_norm:
            self.norm1 = MaskedBatchNorm(dim_h, eps, stats_only=True)
            self.norm2 = MaskedBatchNorm(dim_h, eps)

    @property
    def rate(self) -> float:
        """The dropout in force: 0 in evaluation."""
        return self.dropout if self.training else 0.0

    def fused(self, rows: int) -> bool:
        """Whether the FFN runs as one kernel (JAX ``san.py:146-149`` and
        :174-177): with the residual, inside the kernels' envelope, in
        training with dropout or at a width that is a multiple of 128. With
        BatchNorm that is ``fused_bn_ffn``; without it, ``fused_ffn`` with
        the inner dropout only."""
        return (self.residual and tail_eligible(rows, self.dim_h, self.act)
                and (self.dim_h % 128 == 0 or self.rate > 0.0))

    def ffn(self, h, mask, seed: int):
        """The attention norm, the FFN and its residual over (R, d) rows."""
        if self.fused(h.shape[0]):
            if self.norm1 is None:
                return fused_ffn(h, self.w_ffn1, self.b_ffn1, self.w_ffn2,
                                 self.b_ffn2, seed, self.rate, self.act,
                                 drop2=False)
            mu, var, ga, be = self.norm1(h, mask)
            return fused_bn_ffn(h, mu, torch.rsqrt(var + self.eps), ga, be,
                                self.w_ffn1, self.b_ffn1, self.w_ffn2,
                                self.b_ffn2, seed, self.rate, self.act)
        if self.norm1 is not None:
            h = self.norm1.normalize(h, mask)
        z = get_act(self.act)(h @ self.w_ffn1 + self.b_ffn1)
        h2 = exact_dropout(z, seed, 1, self.rate) @ self.w_ffn2 + self.b_ffn2
        return h + h2 if self.residual else h2

    def forward(self, batch: GraphBatch, x, e,
                gen: Optional[torch.Generator] = None):
        """``gen`` draws the layer's dropout seeds in training. Returns
        (x, e), padded node slots zeroed; e passes through."""
        seeds = [0] * SEEDS_PER_LAYER
        if self.rate > 0.0:
            seeds = draw_seeds(gen, SEEDS_PER_LAYER)
        h = exact_dropout(self.attn(batch, x, e), seeds[0], 0, self.rate)
        h = h @ self.w_o + self.b_o
        if self.residual:
            h = x + h
        h = self.ffn(h, batch.node_mask, seeds[1])
        if self.norm2 is not None:
            h = self.norm2(h, batch.node_mask)
        return torch.where(batch.node_mask[:, None], h, 0.0), e
