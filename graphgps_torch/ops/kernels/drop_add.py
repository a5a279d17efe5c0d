"""Residual add of a dropped branch ``x_in + drop(v)``: the CUDA kernels of
``csrc/drop_add.cu`` (replacing ``graphgps_tpu/ops/pallas/fused_tail.py:270``
``fused_drop_add`` and its backward ``_da_vjp_bwd`` :298) and their plain
PyTorch versions."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import apply_dropout, check_rate, keep_rule, needs_grad

_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + _FWD_ARGTYPES[3:]


def _check_rate(rate: float) -> None:
    check_rate(rate)
    if rate <= 0.0:
        raise ValueError("fused_drop_add: dropout rate must be above 0 (use a "
                         "plain add at rate 0)")


def drop_add_plain(x_in, v, seed, rate: float):
    """Plain version of :func:`fused_drop_add`, same signature; dropout is
    site 0 of the (R, d) view."""
    _check_rate(rate)
    return x_in + apply_dropout(v, seed, 0, rate)


def drop_add_backward_plain(g, seed, rate: float):
    """Plain version of :func:`drop_add_backward`: autograd through
    :func:`drop_add_plain` with the same mask."""
    with torch.enable_grad():
        v = torch.zeros_like(g).requires_grad_()
        out = drop_add_plain(torch.zeros_like(g), v, seed, rate)
        return torch.autograd.grad(out, v, g)[0]


def _launch_forward(x_in, v, seed, rate):
    R, d = v.shape
    dev = v.device
    build.require("x_in", x_in, (R, d), dev)
    build.require("v", v, (R, d), dev)
    t_keep, scale = keep_rule(rate)
    out = torch.empty_like(v)
    fn = build.cfunc("drop_add", "drop_add_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (x_in, v, out)), R * d,
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("fused_drop_add", err)
    fused_drop_add.launches += 1
    return out


def drop_add_backward(g, seed, rate: float):
    """The backward of :func:`fused_drop_add` given the output cotangent
    ``g`` (R, d): returns dv = drop(g) under the forward's mask; dx_in is
    ``g``. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if g.device.type == "cpu":
        return drop_add_backward_plain(g, seed, rate)
    _check_rate(rate)
    if g.device.type != "cuda":
        raise ValueError(f"drop_add_backward: unsupported device {g.device}")
    R, d = g.shape
    dev = g.device
    build.require("g", g, (R, d), dev)
    t_keep, scale = keep_rule(rate)
    dv = torch.empty_like(g)
    fn = build.cfunc("drop_add", "drop_add_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (g, dv)), R * d,
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("drop_add_backward", err)
    drop_add_backward.launches += 1
    return dv


class _DropAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_in, v, seed, rate):
        ctx.conf = (seed, rate)
        return _launch_forward(x_in, v, seed, rate)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return g, drop_add_backward(g, *ctx.conf), None, None


def fused_drop_add(x_in, v, seed, rate: float):
    """x_in, v: (R, d). Returns ``x_in + drop(v)``, dropout at ``rate`` > 0
    drawn from ``seed`` (site 0 of the (R, d) view, ``common.py``).

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated."""
    if v.device.type == "cpu":
        return drop_add_plain(x_in, v, seed, rate)
    _check_rate(rate)
    if v.device.type != "cuda":
        raise ValueError(f"fused_drop_add: unsupported device {v.device}")
    if not needs_grad(x_in, v):
        return _launch_forward(x_in, v, seed, rate)
    return _DropAdd.apply(x_in, v, seed, rate)


fused_drop_add.launches = 0
drop_add_backward.launches = 0
