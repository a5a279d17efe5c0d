"""GPS layer front -- GatedGCN core, masked multi-head attention, the
attention branch's dropout and residual, and the BatchNorm moment partials:
the CUDA kernels of ``csrc/gps_front.cu`` (replacing
``graphgps_tpu/ops/pallas/fused_layer.py:270`` ``fused_gps_front`` and its
backward ``_fl_vjp_bwd`` :352) and their plain PyTorch versions."""
from __future__ import annotations

import ctypes

import torch

from ..mha import merge_heads, mha_core, split_heads
from . import build
from .common import apply_dropout, check_rate, keep_rule, needs_grad, true_f32

# the key-mask mode of the tensor-core attention body (csrc/attn_tc.cuh):
# at most 128 node slots, heads of at most 128 columns; the GatedGCN core
# holds a graph's receivers in shared memory
MAX_NODES = 128
MAX_HEAD_DIM = 128
SMEM_LIMIT = 227 * 1024

_DROP_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_FWD_ARGTYPES = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + _DROP_ARGTYPES)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 40 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + _DROP_ARGTYPES)
# positions of the differentiable tensor inputs among the fifteen
GRAD_INPUTS = (0, 1, 9, 10, 11, 12, 13, 14)   # x, e, wnq, bnq, wc, bc, wo, bo


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
    (``ops/mha.py``) for the global branch; dropout site 0 on the attention
    probabilities ((B*H*N, N) view), site 1 on the out-projection ((B*N, d))."""
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
    num = torch.zeros_like(x2).index_add(0, r, em * (sig * bx[s]))
    den = torch.zeros_like(x2).index_add(0, r, em * sig)
    x_new = ax + num / (den + 1e-6)

    qkv = proj[:, 4 * d:].reshape(B, N, 3 * d)
    q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H) for i in range(3))
    o = merge_heads(mha_core(q, k, v, nmask > 0, scale=scale,
                             drop=lambda p: apply_dropout(p, seed, 0,
                                                          attn_rate)))
    y = apply_dropout(o.reshape(B * N, d) @ wo + bo, seed, 1, drop_rate)
    s_attn = x2 + y

    nm = nmask.reshape(-1)
    return (x_new.reshape(B, N, d), gate.reshape(B, E, d),
            s_attn.reshape(B, N, d), _moments(x_new, nm, cx),
            _moments(gate, emask.reshape(-1), cg), _moments(s_attn, nm, ca))


def gps_front_backward_plain(*args):
    """Plain version of :func:`gps_front_backward`, same signature (without
    ``kept``): autograd through :func:`gps_front_plain` with the same masks."""
    inputs, conf, cots = args[:15], args[15:20], args[20:26]
    with torch.enable_grad():
        ins = list(inputs)
        for i in GRAD_INPUTS:
            ins[i] = inputs[i].detach().requires_grad_()
        outs = gps_front_plain(*ins, *conf)
        return torch.autograd.grad(outs, [ins[i] for i in GRAD_INPUTS], cots)


def _size(symbol: str, nargs: int):
    """A C helper of the library that returns a size."""
    return build.cfunc("gps_front", symbol, [ctypes.c_int] * nargs,
                       ctypes.c_longlong)


def _check_args(x, e, s_loc, r_loc, emask, nmask, cx, cg, ca, wnq, bnq, wc,
                bc, wo, bo, H):
    """Raise unless the arguments are what the kernels take; returns
    (B, N, E, d, device)."""
    B, N, d = x.shape
    E = e.shape[1]
    dev = x.device
    if (N > MAX_NODES or H <= 0 or d % H or d // H > MAX_HEAD_DIM
            or max(_size("gps_front_core_smem", 1)(N),
                   _size("gps_front_core_bwd_smem", 1)(N)) > SMEM_LIMIT):
        raise ValueError(f"fused_gps_front: shape outside the kernel's envelope "
                         f"(N={N} ≤ {MAX_NODES}, d={d} divisible by H={H} "
                         f"into heads of at most {MAX_HEAD_DIM} columns)")
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
    return B, N, E, d, dev


def _drop_args(seed, attn_rate, drop_rate, dev):
    t_a, sc_a = keep_rule(attn_rate)
    t_d, sc_d = keep_rule(drop_rate)
    return build.seed_arg(seed, max(t_a, t_d), dev), t_a, sc_a, t_d, sc_d


def _launch_forward(args, seed, H, scale, attn_rate, drop_rate):
    """The forward kernel. Returns the six outputs and the kept
    (projall (B*N, 7d), attn (B*N, d), the softmax's row maxima and sums
    (B*H*N)) the backward takes back."""
    B, N, E, d, dev = _check_args(*args, H)
    x, e = args[0], args[1]
    f32 = dict(device=dev, dtype=torch.float32)
    x_new = torch.empty_like(x)
    gate = torch.empty_like(e)
    s_attn = torch.empty_like(x)
    moments = torch.empty((3, 2 * d), **f32)
    proj = torch.empty((B * N, 7 * d), **f32)
    attn = torch.empty((B * N, d), **f32)
    mrow = torch.empty((B * H * N,), **f32)
    lrow = torch.empty((B * H * N,), **f32)
    part = torch.empty((3, B, 2 * d), **f32)
    fn = build.cfunc("gps_front", "gps_front_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (x_new, gate, s_attn, moments, proj,
                                     attn, mrow, lrow, part)),
             B, N, E, d, H, float(scale),
             *_drop_args(seed, attn_rate, drop_rate, dev), build.stream_of(dev))
    build.check_launch("fused_gps_front", err)
    fused_gps_front.launches += 1
    px, pg, pa = (m[None].clone() for m in moments)
    return (x_new, gate, s_attn, px, pg, pa), (proj, attn, mrow, lrow)


def gps_front_backward(x, e, s_loc, r_loc, emask, nmask, cx, cg, ca,
                       wnq, bnq, wc, bc, wo, bo, seed, H: int, scale: float,
                       attn_rate: float, drop_rate: float,
                       gx, gg, gsa, gpx, gpg, gpa, kept=None):
    """The backward of :func:`fused_gps_front` given the cotangents of its
    six outputs (gx, gg, gsa like x_new, gate, s_attn; gpx, gpg, gpa (1, 2d)):
    returns (dx, de, dwnq, dbnq, dwc, dbc, dwo, dbo). CPU tensors take the
    plain version; CUDA tensors launch the kernel, which also takes the
    forward kernel's ``kept`` (its outputs x_new, gate, s_attn, its projall
    and attn, and the softmax's row maxima and sums)."""
    inputs = (x, e, s_loc, r_loc, emask, nmask, cx, cg, ca, wnq, bnq, wc, bc,
              wo, bo)
    cots = (gx, gg, gsa, gpx, gpg, gpa)
    if x.device.type == "cpu":
        return gps_front_backward_plain(*inputs, seed, H, scale, attn_rate,
                                        drop_rate, *cots)
    check_rate(attn_rate)
    check_rate(drop_rate)
    if x.device.type != "cuda" or kept is None:
        raise ValueError(f"gps_front_backward: unsupported device {x.device}, "
                         "or no kept tensors")
    B, N, E, d, dev = _check_args(*inputs, H)
    x_new, gate, s_attn, proj, attn, mrow, lrow = kept
    for name, t in (("x_new", x_new), ("s_attn", s_attn), ("gx", gx),
                    ("gsa", gsa)):
        build.require(name, t, (B, N, d), dev)
    for name, t in (("gate", gate), ("gg", gg)):
        build.require(name, t, (B, E, d), dev)
    for name, t in (("gpx", gpx), ("gpg", gpg), ("gpa", gpa)):
        build.require(name, t, (1, 2 * d), dev)
    build.require("proj", proj, (B * N, 7 * d), dev)
    build.require("attn", attn, (B * N, d), dev)
    for name, t in (("mrow", mrow), ("lrow", lrow)):
        build.require(name, t, (B * H * N,), dev)
    em = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    dx, de = torch.empty_like(x), torch.empty_like(e)
    dwnq, dbnq, dwc, dbc, dwo, dbo = (em(d, 7 * d), em(7 * d), em(d, d),
                                      em(d), em(d, d), em(d))
    dproj, dgate = em(B * N, 7 * d), em(B * E, d)
    gsa3, dy, do = em(B * N, d), em(B * N, d), em(B * N, d)
    drow = em(B * H * N)
    scratch = em(_size("gps_front_backward_scratch", 4)(B, N, E, d))
    fn = build.cfunc("gps_front", "gps_front_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (x, e, s_loc, r_loc, emask, nmask, cx, cg, ca,
                              wnq, wc, wo, proj, attn, mrow, lrow, x_new,
                              gate, s_attn, gx, gg, gsa, gpx, gpg, gpa, dx, de,
                              dwnq, dbnq, dwc, dbc, dwo, dbo, dproj, dgate,
                              gsa3, dy, do, drow, scratch)),
             B, N, E, d, H, float(scale),
             *_drop_args(seed, attn_rate, drop_rate, dev), build.stream_of(dev))
    build.check_launch("gps_front_backward", err)
    gps_front_backward.launches += 1
    return dx, de, dwnq, dbnq, dwc, dbc, dwo, dbo


class _GpsFront(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, conf = inputs[:15], inputs[15:]
        outs, kept = _launch_forward(args, *conf)
        # the moment shifts cx/cg/ca are the norms' running means: kept as
        # the tensors given, which the norms replace (never update in place)
        ctx.save_for_backward(*args, *outs[:3], *kept)
        ctx.conf = conf
        return outs

    @staticmethod
    def backward(ctx, *cots):
        saved = ctx.saved_tensors
        grads = gps_front_backward(
            *saved[:15], *ctx.conf, *(c.contiguous() for c in cots),
            kept=saved[15:])
        out = [None] * 20
        for i, gr in zip(GRAD_INPUTS, grads):
            out[i] = gr
        return tuple(out)


def fused_gps_front(x, e, s_loc, r_loc, emask, nmask, cx, cg, ca,
                    wnq, bnq, wc, bc, wo, bo, seed,
                    H: int, scale: float, attn_rate: float, drop_rate: float):
    """x: (B, N, d); e: (B, E, d); s_loc/r_loc: (B, E) int32 graph-local
    endpoints; emask/nmask: (B, E)/(B, N) float 1/0; cx/cg/ca: (d,) moment
    shifts; wnq: (d, 7d) = [A|D|E|B|Wq|Wk|Wv] and bnq: (7d,); wc/bc the edge
    Linear; wo/bo the attention out-projection -- (in, out) weights as in the
    JAX package. ``seed`` draws the dropout of the attention probabilities
    (``attn_rate``) and of the out-projection (``drop_rate``).

    Returns (x_new, gate, s_attn, px, pg, pa): the front's three pre-norm
    tensors and their (1, 2d) masked moment partials, all differentiable
    (x, e and the six weights get gradients; the masks, indices and shifts
    do not). CPU tensors take the plain version (autograd differentiates
    it); CUDA tensors launch the kernel (N ≤ 128, heads of at most 128
    columns), and the backward kernel when differentiated."""
    args = (x, e, s_loc, r_loc, emask, nmask, cx, cg, ca, wnq, bnq, wc, bc,
            wo, bo)
    if x.device.type == "cpu":
        return gps_front_plain(*args, seed, H, scale, attn_rate, drop_rate)
    check_rate(attn_rate)
    check_rate(drop_rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gps_front: unsupported device {x.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, H, scale, attn_rate, drop_rate)[0]
    return _GpsFront.apply(*args, seed, H, scale, attn_rate, drop_rate)


fused_gps_front.launches = 0
gps_front_backward.launches = 0
