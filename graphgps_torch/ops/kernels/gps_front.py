"""GPS layer front -- GatedGCN core, masked multi-head attention, the
attention branch's residual and the BatchNorm moment partials: the CUDA
kernel ``csrc/gps_front.cu`` (replacing
``graphgps_tpu/ops/pallas/fused_layer.py:270`` ``fused_gps_front``) and its
plain PyTorch version."""
from __future__ import annotations

import ctypes

import torch

from ..mha import merge_heads, mha_core, split_heads
from . import build
from .common import check_rate, true_f32

# the in-shared-memory attention holds a graph's N x N scores per head
MAX_NODES = 128
SMEM_LIMIT = 227 * 1024

_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def _moments(v, m, c):
    """(1, 2d) masked shifted moment sums [Σ m(v−c) | Σ m(v−c)²]."""
    y = v - c
    my = m[:, None] * y
    return torch.cat([my.sum(0), (my * y).sum(0)])[None]


def gps_front_plain(x, e, s_loc, r_loc, emask, nmask, cx, cg, ca,
                    wnq, bnq, wc, bc, wo, bo, seed,
                    H: int, scale: float, attn_rate: float, drop_rate: float):
    """Plain version of :func:`fused_gps_front`, same signature: index
    gathers and ``index_add_`` for the GatedGCN core, dense masked attention
    (``ops/mha.py``) for the global branch."""
    check_rate(attn_rate)
    check_rate(drop_rate)
    true_f32()
    B, N, d = x.shape
    E = e.shape[1]
    x2 = x.reshape(B * N, d)
    proj = x2 @ wnq + bnq
    ce = e.reshape(B * E, d) @ wc + bc
    base = (torch.arange(B, device=x.device) * N)[:, None]
    s = (s_loc.long() + base).reshape(-1)
    r = (r_loc.long() + base).reshape(-1)
    ax, dx, ex, bx = proj[:, :d], proj[:, d:2 * d], proj[:, 2 * d:3 * d], \
        proj[:, 3 * d:4 * d]
    gate = dx[r] + ex[s] + ce
    sig = torch.sigmoid(gate)
    em = emask.reshape(-1, 1)
    num = torch.zeros_like(x2).index_add_(0, r, em * (sig * bx[s]))
    den = torch.zeros_like(x2).index_add_(0, r, em * sig)
    x_new = ax + num / (den + 1e-6)

    qkv = proj[:, 4 * d:].reshape(B, N, 3 * d)
    q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H) for i in range(3))
    o = merge_heads(mha_core(q, k, v, nmask > 0, scale=scale))
    s_attn = x2 + (o.reshape(B * N, d) @ wo + bo)

    nm = nmask.reshape(-1)
    return (x_new.reshape(B, N, d), gate.reshape(B, E, d),
            s_attn.reshape(B, N, d), _moments(x_new, nm, cx),
            _moments(gate, emask.reshape(-1), cg), _moments(s_attn, nm, ca))


def fused_gps_front(x, e, s_loc, r_loc, emask, nmask, cx, cg, ca,
                    wnq, bnq, wc, bc, wo, bo, seed,
                    H: int, scale: float, attn_rate: float, drop_rate: float):
    """x: (B, N, d); e: (B, E, d); s_loc/r_loc: (B, E) int32 graph-local
    endpoints; emask/nmask: (B, E)/(B, N) float 1/0; cx/cg/ca: (d,) moment
    shifts; wnq: (d, 7d) = [A|D|E|B|Wq|Wk|Wv] and bnq: (7d,); wc/bc the edge
    Linear; wo/bo the attention out-projection -- (in, out) weights as in the
    JAX package. ``seed``/``attn_rate``/``drop_rate`` keep the TPU signature;
    both rates must be 0.

    Returns (x_new, gate, s_attn, px, pg, pa): the front's three pre-norm
    tensors and their (1, 2d) masked moment partials. CPU tensors take the
    plain version; CUDA tensors launch the kernel (N ≤ 128)."""
    args = (x, e, s_loc, r_loc, emask, nmask, cx, cg, ca, wnq, bnq, wc, bc,
            wo, bo)
    if x.device.type == "cpu":
        return gps_front_plain(*args, seed, H, scale, attn_rate, drop_rate)
    check_rate(attn_rate)
    check_rate(drop_rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gps_front: unsupported device {x.device}")
    B, N, d = x.shape
    E = e.shape[1]
    dev = x.device
    lib = build.load("gps_front")
    lib.gps_front_mha_smem.restype = ctypes.c_size_t
    lib.gps_front_mha_smem.argtypes = [ctypes.c_int] * 3
    lib.gps_front_core_smem.restype = ctypes.c_size_t
    lib.gps_front_core_smem.argtypes = [ctypes.c_int]
    if (N > MAX_NODES or d % H or lib.gps_front_mha_smem(N, d, H) > SMEM_LIMIT
            or lib.gps_front_core_smem(N) > SMEM_LIMIT):
        raise ValueError(f"fused_gps_front: shape outside the kernel's envelope "
                         f"(N={N} ≤ {MAX_NODES}, d={d} divisible by H={H})")
    build.require("x", x, (B, N, d), dev)
    build.require("e", e, (B, E, d), dev)
    build.require("s_loc", s_loc, (B, E), dev, torch.int32)
    build.require("r_loc", r_loc, (B, E), dev, torch.int32)
    build.require("emask", emask, (B, E), dev)
    build.require("nmask", nmask, (B, N), dev)
    for name, t in (("cx", cx), ("cg", cg), ("ca", ca), ("bc", bc),
                    ("bo", bo)):
        build.require(name, t, (d,), dev)
    build.require("wnq", wnq, (d, 7 * d), dev)
    build.require("bnq", bnq, (7 * d,), dev)
    build.require("wc", wc, (d, d), dev)
    build.require("wo", wo, (d, d), dev)

    f32 = dict(device=dev, dtype=torch.float32)
    x_new = torch.empty_like(x)
    gate = torch.empty_like(e)
    s_attn = torch.empty_like(x)
    moments = torch.empty((3, 2 * d), **f32)
    proj = torch.empty((B * N, 7 * d), **f32)
    attn = torch.empty((B * N, d), **f32)
    part = torch.empty((3, B, 2 * d), **f32)
    fn = lib.gps_front_forward
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(*map(build.ptr, args + (x_new, gate, s_attn, moments, proj,
                                     attn, part)),
             B, N, E, d, H, float(scale), build.stream_of(dev))
    build.check_launch("fused_gps_front", err)
    fused_gps_front.launches += 1
    return x_new, gate, s_attn, moments[0:1], moments[1:2], moments[2:3]


fused_gps_front.launches = 0
