"""Masked multi-head attention for padded graph batches (counterpart of
``graphgps_tpu/ops/mha.py:21-75`` and of ``graphgps_tpu/ops/pallas/
flash_mha.py:87-136`` ``mha``, the dispatch between its dense, chunked and
flash rungs). The plain version of the layer front uses :func:`mha_core`;
the Graphormer layer, which the JAX package computes outside any Pallas
kernel, uses :func:`mha`; the unmerged GPS layer's Transformer branch
outside the fused and wide attention's ranges takes :func:`mha_dispatch`."""
from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30
# the dense rung while N <= DENSE_MAX_N and the (B, H, N, N) f32 scores fit
# DENSE_MAX_BYTES; the chunked rung beyond (flash_mha.py:46-47, the JAX
# package's defaults of GGPS_DENSE_MAX_N and GGPS_DENSE_MAX_BYTES)
DENSE_MAX_N = 1024
DENSE_MAX_BYTES = 64 << 20
# the flash rung takes N >= FLASH_MIN_N node slots, a multiple of
# FLASH_LANE (flash_available, flash_mha.py:62, with GGPS_FLASH_MIN_N's
# default; its TPU condition has no counterpart)
FLASH_MIN_N = 256
FLASH_LANE = 128


def mha_core(q, k, v, key_mask, scale: Optional[float] = None,
             drop: Optional[Callable] = None, grad_through_mask: bool = True,
             bias=None):
    """q, k, v: (B, H, N, Dh); key_mask: (B, N) bool; ``bias``: an additive
    (B, H, N, N) term of the logits (Graphormer's spatial bias), added before
    the mask. Masked keys get ``-1e30`` (not ``-inf``), so a graph with no
    real node still gives finite, uniform weights. Softmax in at least f32;
    ``drop`` (the attention dropout) maps the (B, H, N, N) probabilities
    before they weight ``v``. Returns (B, H, N, Dh)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q * scale, k)
    if bias is not None:
        logits = logits + bias
    mask = key_mask[:, None, None, :]
    if grad_through_mask:
        # masked keys take -1e30 in value, while the gradient reaches every
        # logit, as in the TPU kernels' hand-written backward
        # (fused_layer.py:199-204); it differs only for a graph with no real
        # node, whose uniform weights then pass gradient to its q and k
        masked = torch.where(mask, logits.detach(), NEG_INF)
        logits = logits - logits.detach() + masked
    else:
        # as jnp.where in graphgps_tpu/ops/mha.py:54: no gradient to a
        # masked logit
        logits = torch.where(mask, logits, NEG_INF)
    if logits.dtype != torch.float64:    # a float64 run is a reference
        logits = logits.float()
    attn = torch.softmax(logits, dim=-1)
    if drop is not None:
        attn = drop(attn)
    return torch.einsum("bhnm,bhmd->bhnd", attn.to(v.dtype), v)


def mha(q, k, v, key_mask, drop: Optional[Callable] = None, bias=None):
    """Masked attention as the JAX package's ``mha`` dispatch computes it on
    its dense rung (its chunked rung is the same function in less memory),
    and as ``graphgps_tpu/ops/mha.py:35`` ``mha_core`` with a ``bias``.
    ``drop`` is the attention dropout over the (B, H, N, N) probabilities:
    the layers pass the port's hash with the u8 keep rule
    (``kernels/common.py`` ``apply_dropout``: site 0 of the (B*H*N, N) view,
    a seed of its own)."""
    return mha_core(q, k, v, key_mask, drop=drop, grad_through_mask=False,
                    bias=bias)


def takes_dense(B: int, H: int, N: int) -> bool:
    """The rung JAX's "auto" dispatch takes off the TPU: dense while N is at
    most DENSE_MAX_N and the f32 scores fit DENSE_MAX_BYTES. It depends on
    the batch's graph count B, so at some sizes two layouts of the same
    graphs take different (exact) rungs."""
    return N <= DENSE_MAX_N and 4 * B * H * N * N <= DENSE_MAX_BYTES


def flash_available(N: int) -> bool:
    """Whether the flash rung takes N node slots (FLASH_MIN_N, FLASH_LANE)."""
    return N >= FLASH_MIN_N and N % FLASH_LANE == 0


def mha_dispatch(q, k, v, key_mask, seed: int = 0, rate: float = 0.0,
                 bias=None, impl: str = "auto"):
    """Masked attention on the rung ``impl`` names (``gt.attn_impl``): under
    auto the one :func:`takes_dense` picks; dense is :func:`mha` with the
    attention dropout over the (B*H*N, N) view (site 0 of the port's hash,
    ``seed``), chunked is ``chunked_mha`` (keys in chunks of
    ``chunked_mha.CHUNK``), which draws the same masks; flash is the
    ``flash_mha`` kernel, which takes no dropout and only
    :func:`flash_available` sizes (JAX's errors otherwise)."""
    from .chunked_mha import chunked_mha
    from .kernels.common import apply_dropout

    B, H, N, _ = q.shape
    if impl == "flash":
        from .kernels import flash_mha

        if rate > 0.0:
            raise ValueError("gt.attn_impl='flash' cannot apply attention "
                             "dropout (weights are never materialized); use "
                             "'chunked' or 'auto'")
        if not flash_available(N):
            raise ValueError(f"gt.attn_impl='flash' needs lane-aligned "
                             f"N≥{FLASH_MIN_N} (got N={N})")
        return flash_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                         key_mask, bias)
    if impl == "dense" or (impl == "auto" and takes_dense(B, H, N)):
        drop = None
        if rate > 0.0:
            drop = lambda p: apply_dropout(p, seed, 0, rate)  # noqa: E731
        return mha(q, k, v, key_mask, drop, bias)
    return chunked_mha(q, k, v, key_mask, bias, seed, rate)


def split_heads(x, num_heads: int):
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).permute(0, 2, 1, 3)


def merge_heads(x):
    B, H, N, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, H * Dh)
