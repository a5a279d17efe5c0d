"""Edge tail ``x_in + drop(act(gamma*(v-mu)*inv + beta))``: the CUDA kernels
of ``csrc/pre_tail.cu`` (replacing ``graphgps_tpu/ops/pallas/fused_tail.py:189``
``fused_pre_tail`` and its backward ``_pre_vjp_bwd`` :220) and their plain
PyTorch versions."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import act_fn, apply_dropout, check_rate, keep_rule, needs_grad

_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p]


def pre_tail_plain(x_in, v, mu, inv, gamma, beta, seed, rate: float,
                   act: str):
    """Plain version of :func:`fused_pre_tail`, same signature; dropout is
    site 0 of the (R, d) view."""
    check_rate(rate)
    a = act_fn(act)((v - mu) * inv * gamma + beta)
    return x_in + apply_dropout(a, seed, 0, rate)


def pre_tail_backward_plain(v, mu, inv, gamma, beta, g, seed, rate: float,
                            act: str):
    """Plain version of :func:`pre_tail_backward`: autograd through
    :func:`pre_tail_plain` with the same mask."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (v, mu, inv, gamma, beta)]
        out = pre_tail_plain(torch.zeros_like(v), *ins, seed, rate, act)
        return torch.autograd.grad(out, ins, g)


def _launch_forward(x_in, v, mu, inv, gamma, beta, seed, rate, act):
    if act not in build.ACTS:
        raise ValueError(f"fused_pre_tail: unsupported act {act!r}")
    R, d = v.shape
    dev = v.device
    build.require("x_in", x_in, (R, d), dev)
    build.require("v", v, (R, d), dev)
    for name, t in (("mu", mu), ("inv", inv), ("gamma", gamma),
                    ("beta", beta)):
        build.require(name, t, (d,), dev)
    t_keep, scale = keep_rule(rate)
    out = torch.empty_like(v)
    fn = build.cfunc("pre_tail", "pre_tail_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (x_in, v, mu, inv, gamma, beta, out)), R, d,
             build.ACTS[act],
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("fused_pre_tail", err)
    fused_pre_tail.launches += 1
    return out


# the backward kernel's tickets (one per 32-column slab) by device: zeroed
# once here, and every launch leaves them at 0. One stream at a time may use
# a device's tickets.
_tickets = {}


def _tickets_for(dev, n: int):
    """At least ``n`` zeroed int32 tickets on ``dev``, made at the first call
    that needs them; raises rather than make them inside a CUDA graph
    capture (a capture replays the launch, not the zeroing)."""
    t = _tickets.get(dev)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pre_tail_backward: call it once on this "
                               "device and width before a CUDA graph "
                               "capture (its tickets are made then)")
        t = _tickets[dev] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=dev)
    return t


def pre_tail_backward(v, mu, inv, gamma, beta, g, seed, rate: float,
                      act: str):
    """The backward of :func:`fused_pre_tail` given the output cotangent
    ``g`` (R, d): returns (dv, dmu, dinv, dgamma, dbeta); dx_in is ``g``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if v.device.type == "cpu":
        return pre_tail_backward_plain(v, mu, inv, gamma, beta, g, seed, rate,
                                       act)
    check_rate(rate)
    if v.device.type != "cuda" or act not in build.ACTS:
        raise ValueError(f"pre_tail_backward: unsupported device {v.device} "
                         f"or act {act!r}")
    R, d = v.shape
    dev = v.device
    build.require("v", v, (R, d), dev)
    build.require("g", g, (R, d), dev)
    for name, t in (("mu", mu), ("inv", inv), ("gamma", gamma),
                    ("beta", beta)):
        build.require(name, t, (d,), dev)
    scratch_floats = build.cfunc("pre_tail", "pre_tail_backward_scratch",
                                 [ctypes.c_int] * 2, ctypes.c_longlong)
    n_tickets = build.cfunc("pre_tail", "pre_tail_backward_tickets",
                            [ctypes.c_int])
    tickets = _tickets_for(dev, n_tickets(d))
    scratch = torch.empty(scratch_floats(R, d), device=dev)
    dv = torch.empty_like(v)
    dvec = torch.empty((4, d), device=dev)
    t_keep, scale = keep_rule(rate)
    fn = build.cfunc("pre_tail", "pre_tail_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (v, mu, inv, gamma, beta, g, dv, dvec, scratch,
                              tickets)),
             R, d, build.ACTS[act],
             build.seed_arg(seed, t_keep, dev), t_keep, scale,
             build.stream_of(dev))
    build.check_launch("pre_tail_backward", err)
    pre_tail_backward.launches += 1
    return (dv, *dvec.unbind(0))


class _PreTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_in, v, mu, inv, gamma, beta, seed, rate, act):
        ctx.save_for_backward(v, mu, inv, gamma, beta)
        ctx.conf = (seed, rate, act)
        return _launch_forward(x_in, v, mu, inv, gamma, beta, seed, rate, act)

    @staticmethod
    def backward(ctx, g):
        grads = pre_tail_backward(*ctx.saved_tensors, g.contiguous(),
                                  *ctx.conf)
        return (g, *grads, None, None, None)


def fused_pre_tail(x_in, v, mu, inv, gamma, beta, seed, rate: float,
                   act: str):
    """x_in, v: (R, d); mu/inv/gamma/beta: (d,). Returns
    ``x_in + drop(act(gamma*(v-mu)*inv + beta))``, dropout at ``rate`` drawn
    from ``seed`` (site 0 of the (R, d) view, ``common.py``).

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors launch the kernel, and the backward kernel when differentiated."""
    args = (x_in, v, mu, inv, gamma, beta)
    if v.device.type == "cpu":
        return pre_tail_plain(*args, seed, rate, act)
    check_rate(rate)
    if v.device.type != "cuda":
        raise ValueError(f"fused_pre_tail: unsupported device {v.device}")
    if not needs_grad(*args):
        return _launch_forward(*args, seed, rate, act)
    return _PreTail.apply(*args, seed, rate, act)


fused_pre_tail.launches = 0
pre_tail_backward.launches = 0
