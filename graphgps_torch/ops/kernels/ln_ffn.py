"""Graphormer's pre-LN FFN block: the CUDA kernels of ``csrc/ln_ffn.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_combine.py:672`` ``fused_ln_ffn``
and its backward ``_lf_vjp_bwd`` :713) and their plain PyTorch versions."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import (act_fn, apply_dropout, check_rate, keep_rule,
                     needs_grad, true_f32)

# the TPU kernel's LayerNorm eps (fused_combine.py:782 fused_ln_ffn_padded)
EPS = 1e-6

_FWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p]


def ln_ffn_plain(h0, ga, be, w1, b1, w2, b2, seed, r1: float, r2: float,
                 act: str = "gelu", eps: float = EPS):
    """Plain version of :func:`fused_ln_ffn`, same signature. The
    LayerNorm is the TPU kernel's ``_ln``: the row centred first, then its
    mean square (not flax's fast variance). Dropout sites 1 (inner, (R, dh),
    rate ``r1``) and 2 (outer, (R, d), rate ``r2``)."""
    check_rate(r1)
    check_rate(r2)
    true_f32()
    xc = h0 - h0.mean(-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * ga + be
    z = apply_dropout(act_fn(act)(y @ w1 + b1), seed, 1, r1)
    return h0 + apply_dropout(z @ w2 + b2, seed, 2, r2)


def ln_ffn_backward_plain(h0, ga, be, w1, b1, w2, b2, g, seed, r1: float,
                          r2: float, act: str = "gelu", eps: float = EPS):
    """Plain version of the backward: autograd through :func:`ln_ffn_plain`
    with the same masks. Returns (dh0, dga, dbe, dw1, db1, dw2, db2)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_()
               for t in (h0, ga, be, w1, b1, w2, b2)]
        out = ln_ffn_plain(*ins, seed, r1, r2, act, eps)
        return torch.autograd.grad(out, ins, g)


def _require_args(h0, ga, be, w1, b1, w2, b2):
    R, d = h0.shape
    dh = w1.shape[1]
    dev = h0.device
    build.require("h0", h0, (R, d), dev)
    for name, t in (("ga", ga), ("be", be), ("b2", b2)):
        build.require(name, t, (d,), dev)
    build.require("w1", w1, (d, dh), dev)
    build.require("b1", b1, (dh,), dev)
    build.require("w2", w2, (dh, d), dev)
    return R, d, dh, dev


def _check_conf(name: str, r1, r2, act):
    check_rate(r1)
    check_rate(r2)
    if act not in build.ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")


def _launch_forward(args, seed, r1, r2, act, eps, keep: bool):
    """The forward kernel. Returns (out, kept): kept = (y, a1, z, stats),
    the LayerNorm's output, the pre-activation, the inner activation after
    dropout and each row's (mean, rstd), when ``keep`` (a backward
    follows), else None."""
    _check_conf("fused_ln_ffn", r1, r2, act)
    R, d, dh, dev = _require_args(*args)
    out = torch.empty_like(args[0])
    y = torch.empty((R, d), device=dev)
    z = torch.empty((R, dh), device=dev)
    a1 = torch.empty((R, dh), device=dev) if keep else None
    stats = torch.empty((R, 2), device=dev) if keep else None
    t1, s1 = keep_rule(r1)
    t2, s2 = keep_rule(r2)
    fn = build.cfunc("ln_ffn", "ln_ffn_forward", _FWD_ARGTYPES)
    null = ctypes.c_void_p(0)
    err = fn(*map(build.ptr, args + (out, y, z)),
             *((build.ptr(a1), build.ptr(stats)) if keep else (null, null)),
             R, d, dh, build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, s1, t2, s2, eps,
             build.stream_of(dev))
    build.check_launch("fused_ln_ffn", err)
    fused_ln_ffn.launches += 1
    return out, ((y, a1, z, stats) if keep else None)


def ln_ffn_backward(h0, ga, be, w1, b1, w2, b2, g, seed, r1: float,
                    r2: float, act: str = "gelu", eps: float = EPS,
                    kept=None):
    """The backward of :func:`fused_ln_ffn` given the output cotangent ``g``
    (R, d): (dh0, dga, dbe, dw1, db1, dw2, db2). CPU tensors take the plain
    version; CUDA tensors launch the kernel, which also takes the forward
    kernel's ``kept`` (y (R, d), a1 and z (R, dh), stats (R, 2))."""
    args = (h0, ga, be, w1, b1, w2, b2)
    if g.device.type == "cpu":
        return ln_ffn_backward_plain(*args, g, seed, r1, r2, act, eps)
    _check_conf("ln_ffn_backward", r1, r2, act)
    if g.device.type != "cuda" or kept is None:
        raise ValueError(f"ln_ffn_backward: unsupported device {g.device}, "
                         "or no kept tensors")
    R, d, dh, dev = _require_args(*args)
    y, a1, z, stats = kept
    for name, t in (("y", y), ("g", g)):
        build.require(name, t, (R, d), dev)
    for name, t in (("a1", a1), ("z", z)):
        build.require(name, t, (R, dh), dev)
    build.require("stats", stats, (R, 2), dev)
    scratch_floats = build.cfunc("ln_ffn", "ln_ffn_backward_scratch",
                                 [ctypes.c_int] * 3, ctypes.c_longlong)
    e = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    scratch = e(scratch_floats(R, d, dh))
    # dbias = [db2 | db1 | dgamma | dbeta], added by the kernel's last launch
    dh0, dbias, dw1, dw2 = e(R, d), e(3 * d + dh), e(d, dh), e(dh, d)
    da2, da1, dy = e(R, d), e(R, dh), e(R, d)
    t1, s1 = keep_rule(r1)
    t2, s2 = keep_rule(r2)
    fn = build.cfunc("ln_ffn", "ln_ffn_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (h0, ga, w1, w2, y, a1, z, stats, g, dh0, dbias,
                              dw1, dw2, da2, da1, dy, scratch)),
             R, d, dh, build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, s1, t2, s2,
             build.stream_of(dev))
    build.check_launch("ln_ffn_backward", err)
    ln_ffn_backward.launches += 1
    db2, db1, dga, dbe = dbias.split((d, dh, d, d))
    return dh0, dga, dbe, dw1, db1, dw2, db2


class _LnFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, conf = inputs[:7], inputs[7:]
        out, kept = _launch_forward(args, *conf, True)
        ctx.save_for_backward(*args, *kept)
        ctx.conf = conf
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = ln_ffn_backward(*saved[:7], g.contiguous(), *ctx.conf,
                                kept=saved[7:])
        return (*grads, None, None, None, None, None)


def fused_ln_ffn(h0, ga, be, w1, b1, w2, b2, seed, r1: float, r2: float,
                 act: str = "gelu", eps: float = EPS):
    """h0: (R, d); ga, be: (d,) LayerNorm scale and bias; w1: (d, dh);
    b1: (dh,); w2: (dh, d); b2: (d,) -- (in, out) weights as in the JAX
    package. Returns ``h0 + drop_r2(W2 drop_r1(act(W1 LN(h0) + b1)) + b2)``,
    the LayerNorm over the whole row at ``eps``, dropout drawn from
    ``seed``.

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated."""
    args = (h0, ga, be, w1, b1, w2, b2)
    if h0.device.type == "cpu":
        return ln_ffn_plain(*args, seed, r1, r2, act, eps)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_ln_ffn: unsupported device {h0.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, r1, r2, act, eps, False)[0]
    return _LnFFN.apply(*args, seed, r1, r2, act, eps)


fused_ln_ffn.launches = 0
ln_ffn_backward.launches = 0
