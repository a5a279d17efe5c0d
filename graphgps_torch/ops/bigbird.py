"""BigBird's block-sparse attention pattern and its dispatch (counterpart of
``graphgps_tpu/ops/bigbird.py`` ``_block_plan`` :26 and
``bigbird_block_mask`` :59, and of ``graphgps_tpu/ops/pallas/
splash_bigbird.py`` ``splash_available`` :82 and ``bigbird_attention``
:108).

The plan is a static (nb, nb) boolean over blocks of ``block_size`` nodes:
the first and last block rows and columns global, a 3-block sliding
window, and ``num_random_blocks`` random key blocks per middle query block,
drawn with numpy's seeded generator in JAX's order (so the plans are
equal). ``bigbird_attention`` takes the block-sparse kernel
(``kernels/bigbird.py``) on the card where JAX takes splash on the TPU
(no attention dropout, at least ``GGPS_SPLASH_MIN_N`` node slots, a
multiple of 128), and otherwise the dense masked attention with a -1e30
bias off the plan, the attention dropout as on the other dense rungs."""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .mha import NEG_INF, mha

# the block-sparse kernel from this many node slots (splash_bigbird.py:31,
# GGPS_SPLASH_MIN_N, read at import as JAX reads it), on the 128 grid
SPLASH_MIN_N = int(os.environ.get("GGPS_SPLASH_MIN_N", 2048))
SPLASH_LANE = 128
ATTENTION_TYPES = ("block_sparse", "original_full")


@functools.lru_cache(maxsize=64)
def block_plan(n_tokens: int, block_size: int, num_random_blocks: int,
               seed: int = 0, window: int = 3) -> np.ndarray:
    """(nb, nb) bool block plan, JAX's ``_block_plan``: the same draws in
    the same order (the free key blocks of each middle query block, in
    ascending order, then ``rng.choice`` without replacement)."""
    nb = -(-n_tokens // block_size)
    bm = np.zeros((nb, nb), dtype=bool)
    bm[0, :] = bm[-1, :] = True
    bm[:, 0] = bm[:, -1] = True
    half = window // 2
    for i in range(nb):
        bm[i, max(0, i - half):min(nb, i + half + 1)] = True
    rng = np.random.default_rng(seed)
    for i in range(1, nb - 1):
        candidates = np.flatnonzero(~bm[i])
        if len(candidates):
            pick = rng.choice(len(candidates),
                              size=min(num_random_blocks, len(candidates)),
                              replace=False)
            bm[i, candidates[pick]] = True
    bm.setflags(write=False)
    return bm


@functools.lru_cache(maxsize=64)
def bigbird_block_mask(n_tokens: int, block_size: int, num_random_blocks: int,
                       seed: int = 0, window: int = 3) -> np.ndarray:
    """(N, N) bool: the plan expanded to node pairs (JAX's
    ``bigbird_block_mask``)."""
    bm = block_plan(n_tokens, block_size, num_random_blocks, seed, window)
    dense = np.kron(bm, np.ones((block_size, block_size), dtype=bool))
    dense = dense[:n_tokens, :n_tokens]
    dense.setflags(write=False)
    return dense


@functools.lru_cache(maxsize=16)
def plan_mask(n_tokens: int, block_size: int, num_random_blocks: int,
              seed: int, device):
    """:func:`bigbird_block_mask` as a bool tensor on ``device``, made once
    per device."""
    return torch.tensor(bigbird_block_mask(n_tokens, block_size,
                                           num_random_blocks, seed),
                        device=device)


def splash_available(n: int, device) -> bool:
    """Whether ``bigbird_attention`` takes the block-sparse kernel: on the
    card (JAX: on the TPU), at least SPLASH_MIN_N node slots, a multiple of
    SPLASH_LANE."""
    return (torch.device(device).type == "cuda" and n >= SPLASH_MIN_N
            and n % SPLASH_LANE == 0)


def dense_bigbird(q, k, v, key_mask, block_size: int, num_random_blocks: int,
                  seed: int, drop=None):
    """The dense path: masked attention (``mha``) with -1e30 added off the
    plan; ``drop`` maps the probabilities (the attention dropout)."""
    plan = plan_mask(q.shape[2], block_size, num_random_blocks, seed,
                     q.device)
    bias = torch.where(plan, 0.0, NEG_INF).to(q.dtype)[None, None]
    return mha(q, k, v, key_mask, drop, bias)


def bigbird_attention(q, k, v, key_mask, block_size: int,
                      num_random_blocks: int, seed: int, rate: float = 0.0,
                      drop_seed: int = 0):
    """q, k, v: (B, H, N, Dh); key_mask: (B, N) bool. The block-sparse
    kernel where :func:`splash_available` and ``rate`` is 0, else
    :func:`dense_bigbird` with the attention dropout at ``rate`` (site 0 of
    the (B·H·N, N) view, ``drop_seed``). Returns (B, H, N, Dh)."""
    from .kernels import bigbird_block_sparse
    from .kernels.common import apply_dropout

    if rate == 0.0 and splash_available(q.shape[2], q.device):
        return bigbird_block_sparse(q.contiguous(), k.contiguous(),
                                    v.contiguous(), key_mask, block_size,
                                    num_random_blocks, seed)
    drop = None
    if rate > 0.0:
        drop = lambda p: apply_dropout(p, drop_seed, 0, rate)  # noqa: E731
    return dense_bigbird(q, k, v, key_mask, block_size, num_random_blocks,
                         seed, drop)
