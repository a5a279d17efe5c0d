"""The GPS FFN block with its residual: the CUDA kernels of ``csrc/ffn.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_tail.py:387`` ``fused_ffn`` and
its backward ``_ffn_vjp_bwd`` :433) and their plain PyTorch versions.

Two routes by width, with ``bn_ffn``'s rule (``ffn_fused.takes_fused``):
where W1, W2 and a block of rows fit in a block's shared memory
(wn-squirrel's d = 96 and actor's d = 64 among them) persistent fused
blocks, one launch forward and two backward (the block pass and a
fixed-order reduce); wider FFNs a launch sequence over the tensor-core
GEMM. Neither keeps anything for the backward, which recomputes the hidden
units from ``h`` as the TPU kernel does."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import (act_fn, apply_dropout, check_rate, keep_rule,
                     needs_grad, true_f32)
from .ffn_fused import takes_fused

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]


def ffn_plain(h, w1, b1, w2, b2, seed, rate: float, act: str = "relu",
              drop2: bool = True, relu_mask=None):
    """Plain version of :func:`fused_ffn`, same signature. Dropout sites 1
    (inner, (R, dh)) and, with ``drop2``, 2 (outer, (R, d)), both at
    ``rate``. ``relu_mask`` (R, dh), for relu only: the side of the kink each
    unit takes, as 1/0 (``a1 > 0`` of another computation of the same
    pre-activation), in place of this one's own; values part from relu's
    only at a unit within rounding of 0, derivatives follow the mask."""
    check_rate(rate)
    true_f32()
    a1 = h @ w1 + b1
    z = act_fn(act)(a1) if relu_mask is None else a1 * relu_mask
    z = apply_dropout(z, seed, 1, rate)
    a2 = z @ w2 + b2
    return h + (apply_dropout(a2, seed, 2, rate) if drop2 else a2)


def ffn_backward_plain(h, w1, b1, w2, b2, g, seed, rate: float,
                       act: str = "relu", drop2: bool = True,
                       relu_mask=None):
    """Plain version of the backward: autograd through :func:`ffn_plain`
    with the same masks. Returns (dh, dw1, db1, dw2, db2). A comparison with
    the kernel at relu passes the kernel's side of each kink as
    ``relu_mask`` (``bn_ffn.bn_ffn_backward_plain`` says why)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (h, w1, b1, w2, b2)]
        out = ffn_plain(*ins, seed, rate, act, drop2, relu_mask)
        return torch.autograd.grad(out, ins, g)


def _require_args(h, w1, b1, w2, b2):
    R, d = h.shape
    dh = w1.shape[1]
    dev = h.device
    build.require("h", h, (R, d), dev)
    build.require("w1", w1, (d, dh), dev)
    build.require("b1", b1, (dh,), dev)
    build.require("w2", w2, (dh, d), dev)
    build.require("b2", b2, (d,), dev)
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


def _launch_forward(args, seed, rate, act, drop2, keep_a1: bool = False):
    """The forward kernel: out, and with ``keep_a1`` also the kernel's
    pre-activation (R, dh), (out, a1), for a check of relu's kinks."""
    _check_conf("fused_ffn", rate, act)
    R, d, dh, dev = _require_args(*args)
    fused = takes_fused(d, dh)
    out = torch.empty_like(args[0])
    # the sequence's work (the fused route keeps z on chip)
    z = None if fused else torch.empty((R, dh), device=dev)
    a1 = torch.empty((R, dh), device=dev) if keep_a1 else None
    opt = lambda t: build.ptr(t) if t is not None else None  # noqa: E731
    t1, t2, scale = _thresholds(rate, drop2)
    fn = build.cfunc("ffn", "ffn_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (out,)), opt(z), opt(a1), R, d, dh,
             build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, t2, scale,
             int(fused), build.stream_of(dev))
    build.check_launch("fused_ffn", err)
    fused_ffn.launches += 1
    return (out, a1) if keep_a1 else out


def ffn_backward(h, w1, b1, w2, b2, g, seed, rate: float, act: str = "relu",
                 drop2: bool = True):
    """The backward of :func:`fused_ffn` given the output cotangent ``g``
    (R, d): (dh, dw1, db1, dw2, db2). CPU tensors take the plain version;
    CUDA tensors launch the kernel, which recomputes the hidden units from
    ``h`` as the TPU kernel does."""
    args = (h, w1, b1, w2, b2)
    if g.device.type == "cpu":
        return ffn_backward_plain(*args, g, seed, rate, act, drop2)
    _check_conf("ffn_backward", rate, act)
    if g.device.type != "cuda":
        raise ValueError(f"ffn_backward: unsupported device {g.device}")
    R, d, dh, dev = _require_args(*args)
    build.require("g", g, (R, d), dev)
    fused = takes_fused(d, dh) and bool(build.cfunc(
        "ffn", "ffn_fused_backward_fits", [ctypes.c_int] * 2)(d, dh))
    scratch_floats = build.cfunc("ffn", "ffn_backward_scratch",
                                 [ctypes.c_int] * 4, ctypes.c_longlong)
    e = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    scratch = e(scratch_floats(R, d, dh, int(fused)))
    dx, dw1, db1, dw2, db2 = e(R, d), e(d, dh), e(dh), e(dh, d), e(d)
    # the sequence's work (the fused route recomputes a1 and z on chip)
    work = (None,) * 4 if fused else (e(R, dh), e(R, dh), e(R, dh), e(R, d))
    opt = lambda t: build.ptr(t) if t is not None else None  # noqa: E731
    t1, t2, scale = _thresholds(rate, drop2)
    fn = build.cfunc("ffn", "ffn_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (h, w1, b1, w2, g, dx, dw1, db1, dw2, db2)),
             *map(opt, work), build.ptr(scratch), R, d, dh, build.ACTS[act],
             build.seed_arg(seed, max(t1, t2), dev), t1, t2, scale,
             int(fused), build.stream_of(dev))
    build.check_launch("ffn_backward", err)
    ffn_backward.launches += 1
    return dx, dw1, db1, dw2, db2


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, conf = inputs[:5], inputs[5:]
        out = _launch_forward(args, *conf)
        ctx.save_for_backward(*args)
        ctx.conf = conf
        return out

    @staticmethod
    def backward(ctx, g):
        grads = ffn_backward(*ctx.saved_tensors, g.contiguous(), *ctx.conf)
        return (*grads, None, None, None, None)


def fused_ffn(h, w1, b1, w2, b2, seed, rate: float, act: str = "relu",
              drop2: bool = True):
    """h: (R, d); w1: (d, dh); b1: (dh,); w2: (dh, d); b2: (d,) -- (in, out)
    weights as in the JAX package. Returns ``h + drop2(W2 drop1(act(W1 h +
    b1)) + b2)``, dropout at ``rate`` drawn from ``seed``; ``drop2=False``
    leaves the second product's output undropped.

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated."""
    args = (h, w1, b1, w2, b2)
    if h.device.type == "cpu":
        return ffn_plain(*args, seed, rate, act, drop2)
    if h.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {h.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, rate, act, drop2)
    return _FFN.apply(*args, seed, rate, act, drop2)


fused_ffn.launches = 0
ffn_backward.launches = 0
