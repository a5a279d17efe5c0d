"""The Graphormer layer and network (counterparts of
``graphgps_tpu/models/graphormer.py:16-89`` ``GraphormerLayer`` and
``graphgps_tpu/models/networks.py:269-296`` ``GraphormerNet``).

A layer is pre-LN attention with the additive spatial bias, then the pre-LN
MLP block. With the graph token, its state is sequence position 0 of every
graph through the whole stack and its key is never masked. The MLP block
goes through the ``fused_ln_ffn`` kernel under the JAX package's envelope
(``ln_ffn_eligible``, here ``gps_layer.tail_eligible``: width ≥ 64 and a
row count that is a multiple of 8); outside it, through PyTorch ops as
JAX's plain path.

Dropout, three rules as in the JAX package:
- the attention probabilities: the u8 keep rule (``keep_mask_u8``) over the
  port's hash, site 0 of the (B·H·N, N) view;
- inside the kernel: the u8 rule at sites 1 (inner, ``mlp_dropout``) and 2
  (outer, ``dropout``);
- flax ``nn.Dropout`` (the input dropout, the attention output's dropout,
  the plain MLP's two): the exact-rate rule (``exact_dropout``).
A layer draws three seeds per training step (attention, attention output,
MLP block), the network one for its input dropout (sites 0, the nodes, and
1, the graph token).

Weights, in (in, out) layout with their flax names: ``ln_attn``
(``LayerNorm_0``), ``w_qkv``/``b_qkv`` (``Dense_0..2``, q | k | v),
``w_out``/``b_out`` (``Dense_3``), ``ln_ffn`` (``LayerNorm_1``),
``w_ffn1``/``b_ffn1`` (``Dense_4``), ``w_ffn2``/``b_ffn2`` (``Dense_5``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import fused_ln_ffn
from ..ops.kernels.common import apply_dropout, exact_dropout
from ..ops.mha import merge_heads, mha, split_heads
from .common import LayerNorm, dense_params, get_act
from .encoders import FeatureEncoder
from .gps_layer import draw_seeds, tail_eligible

SEEDS_PER_LAYER = 3   # attention, attention output, MLP block


class GraphormerLayer(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0, mlp_dropout: float = 0.0):
        super().__init__()
        if dim_h % num_heads:
            raise ValueError(f"dim_h={dim_h} is not divisible by "
                             f"num_heads={num_heads}")
        self.dim_h, self.num_heads = dim_h, num_heads
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.mlp_dropout = mlp_dropout
        self.ln_attn = LayerNorm(dim_h)
        ws, bs = zip(*(dense_params(dim_h, dim_h) for _ in range(3)))
        self.w_qkv = nn.Parameter(torch.cat(ws, dim=1).detach())
        self.b_qkv = nn.Parameter(torch.cat(bs).detach())
        self.w_out, self.b_out = dense_params(dim_h, dim_h)
        self.ln_ffn = LayerNorm(dim_h)
        self.w_ffn1, self.b_ffn1 = dense_params(dim_h, dim_h)
        self.w_ffn2, self.b_ffn2 = dense_params(dim_h, dim_h)

    @property
    def rates(self):
        """(dropout, attn_dropout, mlp_dropout) in force: 0 in evaluation."""
        if not self.training:
            return 0.0, 0.0, 0.0
        return self.dropout, self.attn_dropout, self.mlp_dropout

    def mlp_block(self, h, seed: int):
        """``h + drop(W2 drop(gelu(W1 LN(h) + b1)) + b2)`` over (R, d)
        rows: the kernel inside the envelope, PyTorch ops outside."""
        drop, _, mlp = self.rates
        if tail_eligible(*h.shape, "gelu"):
            return fused_ln_ffn(h, self.ln_ffn.weight, self.ln_ffn.bias,
                                self.w_ffn1, self.b_ffn1, self.w_ffn2,
                                self.b_ffn2, seed, mlp, drop, "gelu")
        z = get_act("gelu")(self.ln_ffn(h) @ self.w_ffn1 + self.b_ffn1)
        z = exact_dropout(z, seed, 1, mlp) @ self.w_ffn2 + self.b_ffn2
        return h + exact_dropout(z, seed, 2, drop)

    def attention_block(self, batch: GraphBatch, x, tok, bias, seeds):
        """The sequence (B, S, d) after the attention half of the layer:
        the token state prepended as position 0 (its key never masked),
        ``seq + drop(W_o MHA(LN(seq), bias) + b_o)``."""
        d, H = self.dim_h, self.num_heads
        drop, attn_rate, _ = self.rates
        seq = batch.dense_view(x)
        kmask = batch.dense_view(batch.node_mask)
        if tok is not None:
            seq = torch.cat([tok[:, None, :], seq], dim=1)
            kmask = torch.cat([torch.ones_like(kmask[:, :1]), kmask], dim=1)
        qkv = self.ln_attn(seq) @ self.w_qkv + self.b_qkv
        q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H)
                   for i in range(3))
        attn_drop = None
        if attn_rate > 0.0:
            attn_drop = lambda p: apply_dropout(  # noqa: E731
                p, seeds[0], 0, attn_rate)
        o = mha(q, k, v, kmask, attn_drop, bias)
        h = merge_heads(o) @ self.w_out + self.b_out
        return seq + exact_dropout(h, seeds[1], 0, drop)

    def forward(self, batch: GraphBatch, x, tok=None, bias=None,
                gen: Optional[torch.Generator] = None):
        """x: (B*N, d) node rows; ``tok``: (B, d) graph token states or
        None; ``bias``: the (B, H, S, S) attention bias, S = N (+1 with the
        token). Returns (x, tok), padded node slots zeroed."""
        d = self.dim_h
        seeds = [0] * SEEDS_PER_LAYER
        if any(self.rates):
            seeds = draw_seeds(gen, SEEDS_PER_LAYER)
        seq = self.attention_block(batch, x, tok, bias, seeds)
        B, S, _ = seq.shape
        seq = self.mlp_block(seq.reshape(B * S, d), seeds[2]).reshape(B, S, d)
        if tok is not None:
            tok, seq = seq[:, 0, :], seq[:, 1:, :]
        x = seq.reshape(-1, d)
        return torch.where(batch.node_mask[:, None], x, 0.0), tok


class GraphormerNet(nn.Module):
    """FeatureEncoder (TypeDictNode + GraphormerBias) → input dropout on the
    nodes and, a separate draw, on the graph token → L × GraphormerLayer →
    head (``graphormer_graph``: the token state through a Linear)."""

    def __init__(self, cfg, dim_out: int):
        super().__init__()
        from .networks import make_head

        g = cfg.graphormer
        d = g.embed_dim
        self.input_dropout = g.input_dropout
        self.encoder = FeatureEncoder(cfg, d)
        self.layers = nn.ModuleList(
            GraphormerLayer(d, g.num_heads, dropout=g.dropout,
                            attn_dropout=g.attention_dropout,
                            mlp_dropout=g.mlp_dropout)
            for _ in range(g.num_layers))
        self.head = make_head(cfg, d, dim_out)

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """Returns (pred (B, dim_out), true). In training, ``gen`` (a host
        generator) draws every dropout seed."""
        x, _ = self.encoder(batch, gen)
        bias = self.encoder.graphormer.attn_bias(batch)
        tok = self.encoder.graphormer.token_state(batch.num_graphs)
        rate = self.input_dropout if self.training else 0.0
        if rate > 0.0:
            seed = draw_seeds(gen, 1)[0]
            x = exact_dropout(x, seed, 0, rate)
            if tok is not None:
                tok = exact_dropout(tok, seed, 1, rate)
        for layer in self.layers:
            x, tok = layer(batch, x, tok, bias, gen)
        return self.head(batch, x, tok)
