"""Standalone GatedGCN layer core -- the five projections, the gathers, the
gate, the masked aggregation, the node update and the BatchNorm moment
partials: the CUDA kernels of ``csrc/gatedgcn.cu`` (replacing
``graphgps_tpu/ops/pallas/fused_gatedgcn.py:279`` ``fused_gatedgcn`` and its
backward ``_vjp_bwd`` :349) and their plain PyTorch versions. The kernels run
at the true width: the TPU's ``fused_gatedgcn_padded`` (:443) zero-padding to
128 lanes has no counterpart."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import needs_grad, true_f32
from .gps_front import SMEM_LIMIT, _moments

_FWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# positions of the differentiable tensor inputs among the twelve
GRAD_INPUTS = (0, 1, 8, 9, 10, 11)   # x, e, wn, bn, wc, bc
# the most node slots per graph the core holds in shared memory: its backward
# keeps five arrays of N x 64 floats a block (``ggcn_core_bwd_smem``,
# csrc/ggcn_core.cuh). The GatedGCN layer routes longer graphs to the edge
# gate (``edge_gate.py``)
MAX_NODES = SMEM_LIMIT // (5 * 64 * 4)


def gatedgcn_plain(x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc, bc):
    """Plain version of :func:`fused_gatedgcn`, same signature: index
    gathers and ``index_add`` for the aggregation."""
    true_f32()
    B, N, d = x.shape
    E = e.shape[1]
    x2 = x.reshape(B * N, d)
    proj = x2 @ wn + bn
    ce = e.reshape(B * E, d) @ wc + bc
    base = (torch.arange(B, device=x.device) * N)[:, None]
    s = (s_loc.long() + base).reshape(-1)
    r = (r_loc.long() + base).reshape(-1)
    ax, dx, ex, bx = (proj[:, i * d:(i + 1) * d] for i in range(4))
    gate = dx[r] + ex[s] + ce
    sig = torch.sigmoid(gate)
    em = emask.reshape(-1, 1)
    num = torch.zeros_like(x2).index_add(0, r, em * (sig * bx[s]))
    den = torch.zeros_like(x2).index_add(0, r, em * sig)
    xo = ax + num / (den + 1e-6)
    return (xo.reshape(B, N, d), gate.reshape(B, E, d),
            _moments(xo, nmask.reshape(-1), cx),
            _moments(gate, emask.reshape(-1), cg))


def gatedgcn_backward_plain(*args):
    """Plain version of :func:`gatedgcn_backward`, same signature (without
    ``kept``): autograd through :func:`gatedgcn_plain`."""
    inputs, cots = args[:12], args[12:16]
    with torch.enable_grad():
        ins = list(inputs)
        for i in GRAD_INPUTS:
            ins[i] = inputs[i].detach().requires_grad_()
        outs = gatedgcn_plain(*ins)
        return torch.autograd.grad(outs, [ins[i] for i in GRAD_INPUTS], cots)


def _size(symbol: str, nargs: int):
    """A C helper of the library that returns a size."""
    return build.cfunc("gatedgcn", symbol, [ctypes.c_int] * nargs,
                       ctypes.c_longlong)


def _check_args(x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc, bc):
    """Raise unless the arguments are what the kernels take; returns
    (B, N, E, d, device)."""
    B, N, d = x.shape
    E = e.shape[1]
    dev = x.device
    if max(_size("gatedgcn_core_smem", 1)(N),
           _size("gatedgcn_core_bwd_smem", 1)(N)) > SMEM_LIMIT:
        raise ValueError(
            f"fused_gatedgcn: N={N} node slots per graph exceed the core's "
            f"shared memory ({MAX_NODES} at most): long graphs take the "
            "layer's other rung, the Linears and fused_edge_gate "
            "(GatedGCNLayer.unmerged)")
    build.require("x", x, (B, N, d), dev)
    build.require("e", e, (B, E, d), dev)
    build.require("s_loc", s_loc, (B, E), dev, torch.int32)
    build.require("r_loc", r_loc, (B, E), dev, torch.int32)
    build.require("emask", emask, (B, E), dev)
    build.require("nmask", nmask, (B, N), dev)
    for name, t in (("cx", cx), ("cg", cg), ("bc", bc)):
        build.require(name, t, (d,), dev)
    build.require("wn", wn, (d, 4 * d), dev)
    build.require("bn", bn, (4 * d,), dev)
    build.require("wc", wc, (d, d), dev)
    return B, N, E, d, dev


def _launch_forward(args):
    """The forward kernel. Returns the four outputs and the kept projection
    (B*N, 4d) the backward takes back."""
    B, N, E, d, dev = _check_args(*args)
    x, e = args[0], args[1]
    f32 = dict(device=dev, dtype=torch.float32)
    xo = torch.empty_like(x)
    gate = torch.empty_like(e)
    moments = torch.empty((2, 2 * d), **f32)
    proj = torch.empty((B * N, 4 * d), **f32)
    part = torch.empty((2, B, 2 * d), **f32)
    fn = build.cfunc("gatedgcn", "gatedgcn_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (xo, gate, moments, proj, part)),
             B, N, E, d, build.stream_of(dev))
    build.check_launch("fused_gatedgcn", err)
    fused_gatedgcn.launches += 1
    px, pg = (m[None].clone() for m in moments)
    return (xo, gate, px, pg), proj


def gatedgcn_backward(x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc,
                      bc, gx, gg, gpx, gpg, kept=None):
    """The backward of :func:`fused_gatedgcn` given the cotangents of its
    four outputs (gx, gg like xo, gate; gpx, gpg (1, 2d)): returns
    (dx, de, dwn, dbn, dwc, dbc). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which also takes the forward kernel's
    ``kept`` (its outputs xo and gate and its projection)."""
    inputs = (x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc, bc)
    if x.device.type == "cpu":
        return gatedgcn_backward_plain(*inputs, gx, gg, gpx, gpg)
    if x.device.type != "cuda" or kept is None:
        raise ValueError(f"gatedgcn_backward: unsupported device {x.device}, "
                         "or no kept tensors")
    B, N, E, d, dev = _check_args(*inputs)
    xo, gate, proj = kept
    for name, t in (("xo", xo), ("gx", gx)):
        build.require(name, t, (B, N, d), dev)
    for name, t in (("gate", gate), ("gg", gg)):
        build.require(name, t, (B, E, d), dev)
    for name, t in (("gpx", gpx), ("gpg", gpg)):
        build.require(name, t, (1, 2 * d), dev)
    build.require("proj", proj, (B * N, 4 * d), dev)
    em = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    dx, de = torch.empty_like(x), torch.empty_like(e)
    dwn, dbn, dwc, dbc = em(d, 4 * d), em(4 * d), em(d, d), em(d)
    dproj, dgate = em(B * N, 4 * d), em(B * E, d)
    scratch = em(_size("gatedgcn_backward_scratch", 4)(B, N, E, d))
    fn = build.cfunc("gatedgcn", "gatedgcn_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (x, e, s_loc, r_loc, emask, nmask, cx, cg, wn,
                              wc, proj, xo, gate, gx, gg, gpx, gpg, dx, de,
                              dwn, dbn, dwc, dbc, dproj, dgate, scratch)),
             B, N, E, d, build.stream_of(dev))
    build.check_launch("gatedgcn_backward", err)
    gatedgcn_backward.launches += 1
    return dx, de, dwn, dbn, dwc, dbc


class _GatedGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        outs, proj = _launch_forward(args)
        # the moment shifts cx/cg are the norms' running means: kept as the
        # tensors given, which the norms replace (never update in place)
        ctx.save_for_backward(*args, outs[0], outs[1], proj)
        return outs

    @staticmethod
    def backward(ctx, *cots):
        saved = ctx.saved_tensors
        grads = gatedgcn_backward(*saved[:12],
                                  *(c.contiguous() for c in cots),
                                  kept=saved[12:])
        out = [None] * 12
        for i, gr in zip(GRAD_INPUTS, grads):
            out[i] = gr
        return tuple(out)


def fused_gatedgcn(x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc, bc):
    """x: (B, N, d); e: (B, E, d); s_loc/r_loc: (B, E) int32 graph-local
    endpoints; emask/nmask: (B, E)/(B, N) float 1/0; cx/cg: (d,) moment
    shifts (the norms' running means; no gradient); wn: (d, 4d) = [A|D|E|B]
    and bn: (4d,); wc/bc the edge Linear -- (in, out) weights as in the JAX
    package.

    Returns (xo, gate, px, pg): the pre-norm node update
    ``Ax + sum sig*Bx / (sum sig + 1e-6)``, the pre-norm edge update, and
    their (1, 2d) masked moment partials ``[sum m(v-c) | sum m(v-c)^2]``, all
    differentiable (x, e and the four weights get gradients). CPU tensors
    take the plain version (autograd differentiates it); CUDA tensors launch
    the kernel, and the backward kernel when differentiated."""
    args = (x, e, s_loc, r_loc, emask, nmask, cx, cg, wn, bn, wc, bc)
    if x.device.type == "cpu":
        return gatedgcn_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gatedgcn: unsupported device {x.device}")
    if not needs_grad(*args):
        return _launch_forward(args)[0]
    return _GatedGCN.apply(*args)


fused_gatedgcn.launches = 0
gatedgcn_backward.launches = 0
