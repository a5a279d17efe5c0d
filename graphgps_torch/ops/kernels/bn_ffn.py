"""SAN's attention-norm apply + FFN block: the CUDA kernels of
``csrc/bn_ffn.cu`` (replacing ``graphgps_tpu/ops/pallas/fused_combine.py:440``
``fused_bn_ffn`` and its backward ``_bf_vjp_bwd`` :483) and their plain
PyTorch versions.

Two routes by width (``ffn_fused.takes_fused``, the rule ``ffn`` shares):
where W1, W2 and a block of rows fit in a block's shared
memory (``csrc/ffn_fused.cuh``; SAN's d = 64 among them) one fused launch
forward and one plus a fixed-order reduce backward; wider FFNs a launch
sequence over the tensor-core GEMM."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import (act_fn, apply_dropout, check_rate, keep_rule,
                     needs_grad, true_f32)
from .ffn_fused import takes_fused

_FWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]

def bn_ffn_plain(s, mu, inv, ga, be, w1, b1, w2, b2, seed, rate: float,
                 act: str = "relu", drop2: bool = False, relu_mask=None):
    """Plain version of :func:`fused_bn_ffn`, same signature. Dropout sites
    1 (inner, (R, dh)) and, with ``drop2``, 2 (outer, (R, d)), both at
    ``rate``. ``relu_mask`` (R, dh), for relu only: the side of the kink each
    unit takes, as 1/0 (``a1 > 0`` of another computation of the same
    pre-activation), in place of this one's own; values part from relu's
    only at a unit within rounding of 0, derivatives follow the mask."""
    check_rate(rate)
    true_f32()
    h = (s - mu) * inv * ga + be
    a1 = h @ w1 + b1
    z = act_fn(act)(a1) if relu_mask is None else a1 * relu_mask
    z = apply_dropout(z, seed, 1, rate)
    a2 = z @ w2 + b2
    return h + (apply_dropout(a2, seed, 2, rate) if drop2 else a2)


def bn_ffn_backward_plain(s, mu, inv, ga, be, w1, b1, w2, b2, g, seed,
                          rate: float, act: str = "relu",
                          drop2: bool = False, relu_mask=None):
    """Plain version of the backward: autograd through :func:`bn_ffn_plain`
    with the same masks. Returns (ds, dmu, dinv, dga, dbe, dw1, db1, dw2,
    db2). relu's derivative jumps at 0: two computations of the
    pre-activation in another summation order may put a unit within
    rounding of 0 on either side, and that unit's row of ds and column of
    dW1 then part. A comparison with the kernel passes the kernel's side of
    each kink as ``relu_mask`` (its kept a1 > 0)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_()
               for t in (s, mu, inv, ga, be, w1, b1, w2, b2)]
        out = bn_ffn_plain(*ins, seed, rate, act, drop2, relu_mask)
        return torch.autograd.grad(out, ins, g)


def _require_args(s, mu, inv, ga, be, w1, b1, w2, b2):
    R, d = s.shape
    dh = w1.shape[1]
    dev = s.device
    build.require("s", s, (R, d), dev)
    for name, t in (("mu", mu), ("inv", inv), ("ga", ga), ("be", be),
                    ("b2", b2)):
        build.require(name, t, (d,), dev)
    build.require("w1", w1, (d, dh), dev)
    build.require("b1", b1, (dh,), dev)
    build.require("w2", w2, (dh, d), dev)
    return R, d, dh, dev


def _check_conf(name: str, rate, act):
    check_rate(rate)
    if act not in build.ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")


def _thresholds(rate: float, drop2: bool):
    """(t1, t2, scale): the inner and outer sites' keep thresholds (t2 = 0
    without ``drop2``) and the one keep scale."""
    t, scale = keep_rule(rate)
    return t, (t if drop2 else 0), scale


def _launch_forward(args, seed, rate, act, drop2, keep: bool):
    """The forward kernel. Returns (out, kept): kept = (h, a1, z), the
    normed input, the pre-activation and the inner activation after
    dropout, when ``keep`` (a backward follows), else None."""
    _check_conf("fused_bn_ffn", rate, act)
    R, d, dh, dev = _require_args(*args)
    fused = takes_fused(d, dh)
    out = torch.empty_like(args[0])
    e = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    work = not fused or keep
    h, z = (e(R, d), e(R, dh)) if work else (None, None)
    a1 = e(R, dh) if keep else None
    opt = lambda t: build.ptr(t) if t is not None else None  # noqa: E731
    t1, t2, scale = _thresholds(rate, drop2)
    fn = build.cfunc("bn_ffn", "bn_ffn_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (out,)), opt(h), opt(z), opt(a1), R, d,
             dh, build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, t2, scale,
             int(fused), build.stream_of(dev))
    build.check_launch("fused_bn_ffn", err)
    fused_bn_ffn.launches += 1
    return out, ((h, a1, z) if keep else None)


def bn_ffn_backward(s, mu, inv, ga, be, w1, b1, w2, b2, g, seed,
                    rate: float, act: str = "relu", drop2: bool = False,
                    kept=None):
    """The backward of :func:`fused_bn_ffn` given the output cotangent ``g``
    (R, d): (ds, dmu, dinv, dga, dbe, dw1, db1, dw2, db2). CPU tensors take
    the plain version; CUDA tensors launch the kernel, which also takes the
    forward kernel's ``kept`` (h (R, d), a1 and z (R, dh))."""
    args = (s, mu, inv, ga, be, w1, b1, w2, b2)
    if g.device.type == "cpu":
        return bn_ffn_backward_plain(*args, g, seed, rate, act, drop2)
    _check_conf("bn_ffn_backward", rate, act)
    if g.device.type != "cuda" or kept is None:
        raise ValueError(f"bn_ffn_backward: unsupported device {g.device}, "
                         "or no kept tensors")
    R, d, dh, dev = _require_args(*args)
    fused = takes_fused(d, dh)
    h, a1, z = kept
    for name, t in (("h", h), ("g", g)):
        build.require(name, t, (R, d), dev)
    for name, t in (("a1", a1), ("z", z)):
        build.require(name, t, (R, dh), dev)
    scratch_floats = build.cfunc("bn_ffn", "bn_ffn_backward_scratch",
                                 [ctypes.c_int] * 4, ctypes.c_longlong)
    e = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    scratch = e(scratch_floats(R, d, dh, int(fused)))
    ds, dvec, dw1, db1, dw2, db2 = e(R, d), e(4, d), e(d, dh), e(dh), \
        e(dh, d), e(d)
    # the launch sequence's work (the fused route keeps it on chip)
    da2, da1, dhh = (None,) * 3 if fused else (e(R, d), e(R, dh), e(R, d))
    opt = lambda t: build.ptr(t) if t is not None else None  # noqa: E731
    t1, t2, scale = _thresholds(rate, drop2)
    fn = build.cfunc("bn_ffn", "bn_ffn_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (s, mu, inv, ga, w1, w2, h, a1, z, g, ds, dvec,
                              dw1, db1, dw2, db2)),
             opt(da2), opt(da1), opt(dhh), build.ptr(scratch), R, d, dh,
             build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, t2, scale,
             int(fused), build.stream_of(dev))
    build.check_launch("bn_ffn_backward", err)
    bn_ffn_backward.launches += 1
    dmu, dinv, dga, dbe = dvec.unbind(0)
    return ds, dmu, dinv, dga, dbe, dw1, db1, dw2, db2


class _BnFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, conf = inputs[:9], inputs[9:]
        out, kept = _launch_forward(args, *conf, True)
        ctx.save_for_backward(*args, *kept)
        ctx.conf = conf
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = bn_ffn_backward(*saved[:9], g.contiguous(), *ctx.conf,
                                kept=saved[9:])
        return (*grads, None, None, None, None)


def fused_bn_ffn(s, mu, inv, ga, be, w1, b1, w2, b2, seed, rate: float,
                 act: str = "relu", drop2: bool = False):
    """s: (R, d); mu, inv, ga, be: (d,) the norm's mean, rsqrt(var + eps),
    scale and bias; w1: (d, dh); b1: (dh,); w2: (dh, d); b2: (d,) -- (in,
    out) weights as in the JAX package. Returns ``h + W2 drop(act(W1 h +
    b1)) + b2`` with ``h = (s − mu)·inv·ga + be`` (the residual rides the
    normed tensor), the second product's output dropped too with ``drop2``;
    dropout at ``rate`` drawn from ``seed``.

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated
    (its gradients of mu and inv carry on through the caller's statistics)."""
    args = (s, mu, inv, ga, be, w1, b1, w2, b2)
    if s.device.type == "cpu":
        return bn_ffn_plain(*args, seed, rate, act, drop2)
    if s.device.type != "cuda":
        raise ValueError(f"fused_bn_ffn: unsupported device {s.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, rate, act, drop2, False)[0]
    return _BnFFN.apply(*args, seed, rate, act, drop2)


fused_bn_ffn.launches = 0
bn_ffn_backward.launches = 0
