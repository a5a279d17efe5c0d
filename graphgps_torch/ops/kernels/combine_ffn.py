"""GPS layer branch combine + FFN: the CUDA kernels of
``csrc/combine_ffn.cu`` (replacing ``graphgps_tpu/ops/pallas/fused_combine.py:183``
``fused_combine_ffn`` and its backward ``_cf_vjp_bwd`` :235) and their plain
PyTorch versions."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import (act_fn, apply_dropout, check_rate, keep_rule,
                     needs_grad, true_f32)

_FWD_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def combine_ffn_plain(x_in, v_loc, mu_x, inv_x, ga_x, be_x,
                      s_attn, mu_a, inv_a, ga_a, be_a,
                      w1, b1, w2, b2, seed, rate: float, act: str,
                      relu_mask=None):
    """Plain version of :func:`fused_combine_ffn`, same signature; dropout
    sites 0 (local tail, (R, d)), 1 (FFN inner, (R, dh)), 2 (FFN outer,
    (R, d)). ``relu_mask`` (R, dh), for relu only, as in
    ``ffn.ffn_plain``: the side of the kink each FFN unit takes, 1/0, in
    place of this computation's own."""
    check_rate(rate)
    true_f32()
    a = act_fn(act)
    h = (x_in + apply_dropout(a((v_loc - mu_x) * inv_x * ga_x + be_x), seed,
                              0, rate)
         + ((s_attn - mu_a) * inv_a * ga_a + be_a))
    a1 = h @ w1 + b1
    z = apply_dropout(a(a1) if relu_mask is None else a1 * relu_mask, seed, 1,
                      rate)
    return h + apply_dropout(z @ w2 + b2, seed, 2, rate)


def combine_ffn_backward_plain(x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn,
                               mu_a, inv_a, ga_a, be_a, w1, b1, w2, b2, g,
                               seed, rate: float, act: str, relu_mask=None):
    """Plain version of the backward: autograd through
    :func:`combine_ffn_plain` with the same masks (and ``relu_mask``).
    Returns the gradients of all fifteen tensor inputs, in order."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_()
               for t in (x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a,
                         inv_a, ga_a, be_a, w1, b1, w2, b2)]
        out = combine_ffn_plain(*ins, seed, rate, act, relu_mask)
        return torch.autograd.grad(out, ins, g)


def _require_args(x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a, inv_a,
                  ga_a, be_a, w1, b1, w2, b2):
    R, d = x_in.shape
    dh = w1.shape[1]
    dev = x_in.device
    for name, t in (("x_in", x_in), ("v_loc", v_loc), ("s_attn", s_attn)):
        build.require(name, t, (R, d), dev)
    for name, t in (("mu_x", mu_x), ("inv_x", inv_x), ("ga_x", ga_x),
                    ("be_x", be_x), ("mu_a", mu_a), ("inv_a", inv_a),
                    ("ga_a", ga_a), ("be_a", be_a), ("b2", b2)):
        build.require(name, t, (d,), dev)
    build.require("w1", w1, (d, dh), dev)
    build.require("b1", b1, (dh,), dev)
    build.require("w2", w2, (dh, d), dev)
    return R, d, dh, dev


def _launch_forward(args, seed, rate, act, keep: bool):
    """The forward kernel. Returns (out, h, z, a1); a1, the FFN's
    pre-activation, only when ``keep`` (a backward follows)."""
    if act not in build.ACTS:
        raise ValueError(f"fused_combine_ffn: unsupported act {act!r}")
    R, d, dh, dev = _require_args(*args)
    out = torch.empty_like(args[0])
    h = torch.empty_like(args[0])
    z = torch.empty((R, dh), device=dev)
    a1 = torch.empty((R, dh), device=dev) if keep else None
    t_keep, scale = keep_rule(rate)
    fn = build.cfunc("combine_ffn", "combine_ffn_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (out, h, z)),
             ctypes.c_void_p(a1.data_ptr() if keep else 0), R, d, dh,
             build.ACTS[act],
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("fused_combine_ffn", err)
    fused_combine_ffn.launches += 1
    return out, h, z, a1


def combine_ffn_backward(x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn,
                         mu_a, inv_a, ga_a, be_a, w1, b1, w2, b2, g, seed,
                         rate: float, act: str, kept=None):
    """The backward of :func:`fused_combine_ffn` given the output cotangent
    ``g`` (R, d): the gradients of its fifteen tensor inputs, in order
    (dx_in, dv_loc, the four x-norm vectors, ds_attn, the four attention-norm
    vectors, dw1, db1, dw2, db2). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which also takes the forward kernel's ``kept``
    (h (R, d), a1 and z (R, dh))."""
    args = (x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a, inv_a, ga_a,
            be_a, w1, b1, w2, b2)
    if g.device.type == "cpu":
        return combine_ffn_backward_plain(*args, g, seed, rate, act)
    check_rate(rate)
    if g.device.type != "cuda" or act not in build.ACTS or kept is None:
        raise ValueError(f"combine_ffn_backward: unsupported device "
                         f"{g.device} or act {act!r}, or no kept tensors")
    R, d, dh, dev = _require_args(*args)
    h, a1, z = kept
    for name, t in (("h", h), ("g", g)):
        build.require(name, t, (R, d), dev)
    for name, t in (("a1", a1), ("z", z)):
        build.require(name, t, (R, dh), dev)
    scratch_floats = build.cfunc("combine_ffn", "combine_ffn_backward_scratch",
                                 [ctypes.c_int] * 3, ctypes.c_longlong)
    scratch = torch.empty(scratch_floats(R, d, dh), device=dev)
    e = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    dxin, dv, dsa, dvec = e(R, d), e(R, d), e(R, d), e(8, d)
    dw1, db1, dw2, db2 = e(d, dh), e(dh), e(dh, d), e(d)
    da2, da1 = e(R, d), e(R, dh)
    t_keep, scale = keep_rule(rate)
    fn = build.cfunc("combine_ffn", "combine_ffn_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a,
                              inv_a, ga_a, w1, w2, h, a1, z, g, dxin, dv, dsa,
                              dvec, dw1, db1, dw2, db2, da2, da1, scratch)),
             R, d, dh, build.ACTS[act],
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("combine_ffn_backward", err)
    combine_ffn_backward.launches += 1
    dmux, divx, dgax, dbex, dmua, diva, dgaa, dbea = dvec.unbind(0)
    return (dxin, dv, dmux, divx, dgax, dbex, dsa, dmua, diva, dgaa, dbea,
            dw1, db1, dw2, db2)


class _CombineFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, (seed, rate, act) = inputs[:15], inputs[15:]
        out, h, z, a1 = _launch_forward(args, seed, rate, act, True)
        ctx.save_for_backward(*args, h, a1, z)
        ctx.conf = (seed, rate, act)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = combine_ffn_backward(*saved[:15], g.contiguous(), *ctx.conf,
                                     kept=saved[15:])
        return (*grads, None, None, None)


def fused_combine_ffn(x_in, v_loc, mu_x, inv_x, ga_x, be_x,
                      s_attn, mu_a, inv_a, ga_a, be_a,
                      w1, b1, w2, b2, seed, rate: float, act: str):
    """x_in, v_loc, s_attn: (R, d); the norm vectors: (d,); w1: (d, dh);
    b1: (dh,); w2: (dh, d); b2: (d,) -- (in, out) weights as in the JAX
    package. Returns ``h + drop2(W2 drop1(act(W1 h + b1)) + b2)`` with
    ``h = x_in + drop0(act(bn_x(v_loc))) + bn_a(s_attn)``, dropout at
    ``rate`` drawn from ``seed``.

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated."""
    args = (x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a, inv_a, ga_a,
            be_a, w1, b1, w2, b2)
    if x_in.device.type == "cpu":
        return combine_ffn_plain(*args, seed, rate, act)
    check_rate(rate)
    if x_in.device.type != "cuda":
        raise ValueError(f"fused_combine_ffn: unsupported device "
                         f"{x_in.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, rate, act, False)[0]
    return _CombineFFN.apply(*args, seed, rate, act)


fused_combine_ffn.launches = 0
combine_ffn_backward.launches = 0
