"""Chunked (memory-efficient) masked multi-head attention (counterpart of
``graphgps_tpu/ops/chunked_mha.py:26-89`` ``chunked_mha``).

An online softmax over key chunks: per chunk the logits of every query
against CHUNK keys, the running maximum ``m``, the running sum ``l`` of
the undropped weights and the running output ``acc``; the output is
``acc / l``. Exact, like the dense form, in O(N·chunk) memory per chunk. In
training each chunk runs under ``torch.utils.checkpoint``, as JAX's scan
body runs under ``jax.checkpoint``: the backward recomputes the chunk's
weights from its saved carry instead of keeping the (B, H, N, N) weights.

Attention dropout is the u8 rule over the port's hash on the
un-normalised weights of the chunk, keyed on (seed, site 0, row of the
(B·H·N, N) view, global key column): the chunked rung drops exactly the
units that the dense ``mha`` drops, and ``l`` sums the undropped weights,
so both compute dropout on the softmax."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .kernels.common import dropout_mask
from .mha import NEG_INF

CHUNK = 128


def _chunk_step(m, l, acc, qs, kk, vv, mm, bb, seed: int, rate: float,
                c0: int, N: int):
    """One key chunk of the recurrence: the carry (m, l, acc) after keys
    ``c0 .. c0 + kk.shape[2]``."""
    logits = torch.einsum("bhnd,bhmd->bhnm", qs, kk.to(qs.dtype))
    if bb is not None:
        logits = logits + bb.to(logits.dtype)
    logits = torch.where(mm[:, None, None, :], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    mask = dropout_mask(seed, 0, p.numel() // p.shape[-1], p.shape[-1], rate,
                        p.device, col0=c0, width=N)
    if mask is not None:
        p = p * mask.reshape(p.shape)
    acc_new = acc * corr + torch.einsum("bhnm,bhmd->bhnd", p,
                                        vv.to(p.dtype))
    return m_new, l_new, acc_new


def chunked_mha(q, k, v, key_mask, bias=None, seed: int = 0,
                rate: float = 0.0):
    """q, k, v: (B, H, N, Dh); key_mask: (B, N) bool; ``bias``: an additive
    (B, H, N, N) term of the logits. Scales q by 1/√Dh, masks keys with
    -1e30 (a graph with no real node gets uniform weights), accumulates in
    f32 (f64 for a float64 run, a reference), and applies attention dropout
    at ``rate`` from ``seed``. Keys in chunks of CHUNK, a last chunk maybe
    shorter. Returns (B, H, N, Dh) in v's dtype."""
    B, H, N, Dh = q.shape
    acc_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    qs = (q * Dh ** -0.5).to(acc_dtype)
    m = torch.full((B, H, N, 1), NEG_INF, dtype=acc_dtype, device=q.device)
    l = torch.zeros((B, H, N, 1), dtype=acc_dtype, device=q.device)
    acc = torch.zeros((B, H, N, Dh), dtype=acc_dtype, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v) + ((bias,) if bias is not None
                                              else ()))
    for c0 in range(0, N, CHUNK):
        sl = slice(c0, min(N, c0 + CHUNK))
        args = (m, l, acc, qs, k[:, :, sl], v[:, :, sl], key_mask[:, sl],
                None if bias is None else bias[..., sl], seed, rate, c0, N)
        if remat:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    return (acc / torch.clamp(l, min=1e-30)).to(v.dtype)
