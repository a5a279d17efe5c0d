"""Helpers shared by the kernel wrappers and their plain versions: the
activations, the dropout rules (one counter hash, the same in
``csrc/common.cuh``), and the f32 setting of the plain versions."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def act_fn(name: str):
    """The activations the kernels take (codes in ``build.ACTS``); gelu is
    the exact-erf form."""
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return F.gelu
    if name == "identity":
        return lambda z: z
    raise NotImplementedError(f"activation {name!r} is not ported")


def check_rate(rate: float) -> None:
    """A dropout rate the kernels take: 0 ≤ rate < 1."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")


def true_f32() -> None:
    """Plain versions compare with the kernels in true f32: no TF32 in
    matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Dropout. The TPU's on-chip bits cannot be matched (its PRNG is stateful, and
# even the interpret-mode hash depends on the grid step and the block shape),
# so the port defines its own: a counter hash of (seed, site, row, column)
# over a site's logical 2-D (rows, cols) view, independent of any tiling.
# ``mix32`` is the finalizer of graphgps_tpu/ops/pallas/fused_tail.py
# ``_bits``; the 64-bit counter ``idx = row * cols + col`` enters as
# ``mix32(lo ^ mix32(hi ^ key))`` with ``key = mix32(seed + 0x9E3779B9 *
# (site + 1))``. The keep rule is the TPU kernels' u8 grid
# (fused_tail.py ``_keep``): t = clamp(round(rate * 256), 1, 255), keep when
# (bits & 255) ≥ t, kept values scaled by 1 / (1 − t/256). Here it runs in
# torch int64 ops (every value kept in [0, 2^32), products split in 16-bit
# halves so nothing overflows); csrc/common.cuh runs it in uint32, so a kernel
# and its plain version draw bit-identical masks. A seed is an int or a
# one-element int32 tensor (an element of a training step's seed tensor,
# ``models/gps_layer.py`` ``StepSeeds``), with the same masks for the same
# 32 bits; a kernel on the card takes only the tensor (``build.seed_arg``).

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for ``x`` in [0, 2^32) (an int64 tensor or an int) and
    a constant c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def drop_key(seed, site: int):
    """The hash key of a site: an int for an int ``seed`` or a seed tensor
    that carries the value it holds (``host_value``: an eager step's,
    ``models/gps_layer.py`` ``StepSeeds``, whose seeds were drawn on the
    host: the key then costs no device op); for another seed tensor (a
    one-element int32 tensor, its bits read as uint32 as the kernels read
    them: a captured step's) a 0-d int64 tensor on its device, with the
    same value and no host synchronisation."""
    if torch.is_tensor(seed):
        host = getattr(seed, "host_value", None)
        if host is None:
            s = seed.reshape(()).to(torch.int64) & _M32
            return _mix32((s + (0x9E3779B9 * (site + 1) & _M32)) & _M32)
        seed = host
    return _mix32((int(seed) + 0x9E3779B9 * (site + 1)) & _M32)


def device_seed(seed: int, device) -> torch.Tensor:
    """``seed``'s 32 bits in a one-element int32 tensor on ``device``: the
    form in which a kernel wrapper takes a dropout seed on the card."""
    s = int(seed) & _M32
    return torch.tensor([s - (s >> 31 << 32)], dtype=torch.int32,
                        device=device)


@functools.lru_cache(maxsize=None)
def keep_rule(rate: float) -> Tuple[int, float]:
    """(t, scale) of a rate: t = 0 (scale 1) means no dropout. ``scale`` is
    the f32 value both versions multiply by."""
    check_rate(rate)
    if rate == 0.0:
        return 0, 1.0
    t = min(max(int(round(rate * 256)), 1), 255)
    return t, float(np.float32(1.0 / (1.0 - t / 256.0)))


def drop_bits(seed, site: int, rows: int, cols: int, device=None,
              row0: int = 0, col0: int = 0, width: Optional[int] = None):
    """(rows, cols) int64 hash values in [0, 2^32) of view rows
    ``row0 .. row0 + rows`` and columns ``col0 .. col0 + cols`` of a view
    ``width`` columns wide (by default ``cols``): a block of the view draws
    what the whole view draws there."""
    width = cols if width is None else width
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(col0, col0 + cols, dtype=torch.int64, device=device)
    idx = r[:, None] * width + c[None, :]
    hi = _mix32((idx >> 32) ^ drop_key(seed, site))
    return _mix32((idx & _M32) ^ hi)


def dropout_mask(seed, site: int, rows: int, cols: int, rate: float,
                 device=None, col0: int = 0,
                 width: Optional[int] = None) -> Optional[torch.Tensor]:
    """The f32 (rows, cols) multiplier of a site: 0 where dropped, the keep
    scale where kept; None when rate is 0. ``col0`` and ``width`` place the
    block in a wider view, as in :func:`drop_bits`."""
    t, scale = keep_rule(rate)
    if t == 0:
        return None
    keep = (drop_bits(seed, site, rows, cols, device, col0=col0,
                      width=width) & 255) >= t
    return keep.to(torch.float32) * scale


def apply_dropout(v, seed, site: int, rate: float):
    """``v`` times its site's mask over the view (v.numel() / cols, cols),
    cols = v.shape[-1] (``v`` itself at rate 0)."""
    cols = v.shape[-1]
    m = dropout_mask(seed, site, v.numel() // cols, cols, rate, v.device)
    return v if m is None else v * m.reshape(v.shape)


def exact_dropout(v, seed, site: int, rate: float):
    """flax ``nn.Dropout``'s rule over the port's counter hash: keep with
    probability 1 − rate (to 2⁻²⁴; flax draws ``jax.random.bernoulli``),
    kept values divided by 1 − rate, on the view (v.numel() / cols, cols),
    cols = v.shape[-1]. The JAX package's dropout outside its kernels
    (``nn.Dropout``) keeps this rate exactly where the kernels' u8 grid
    rounds it; the top 24 bits of the hash give u in [0, 1), kept when
    u < 1 − rate. ``v`` itself at rate 0."""
    check_rate(rate)
    if rate == 0.0:
        return v
    cols = v.shape[-1]
    bits = drop_bits(seed, site, v.numel() // cols, cols, v.device)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    keep = (u < 1.0 - rate).reshape(v.shape)
    return torch.where(keep, v / (1.0 - rate), 0.0)


def needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate a call on ``tensors``: the
    kernels' autograd Functions are used only then (evaluation launches the
    forward kernel alone)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if torch.is_tensor(t))
