"""GatedGCN gather/gate/aggregate middle for long graphs -- the gathers by
sender and receiver, the gate, and the masked num/den aggregation, from
projections the caller computed: the CUDA kernels of ``csrc/edge_gate.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_edge_gate.py:120``
``fused_edge_gate`` and its backward ``_vjp_bwd`` :167) and their plain
PyTorch versions. The kernels take the edge axis as it is and the true width:
the TPU's (B, T, 128) edge tiles and its zero-padding to 128 lanes have no
counterpart."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import needs_grad
from .gps_front import SMEM_LIMIT

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# positions of the differentiable inputs among the six
GRAD_INPUTS = (0, 1, 2)   # pd, peb, ce


def edge_gate_plain(pd, peb, ce, s_loc, r_loc, emask):
    """Plain version of :func:`fused_edge_gate`, same signature: index
    gathers and ``index_add`` for the aggregation. An endpoint outside
    ``[0, N)`` gathers zeros and scatters nowhere, as in the kernels."""
    B, N, d = pd.shape
    s_ok = ((s_loc >= 0) & (s_loc < N)).reshape(-1, 1).to(pd.dtype)
    r_ok = ((r_loc >= 0) & (r_loc < N)).reshape(-1, 1).to(pd.dtype)
    base = (torch.arange(B, device=pd.device) * N)[:, None]
    s = (s_loc.long().clamp(0, N - 1) + base).reshape(-1)
    r = (r_loc.long().clamp(0, N - 1) + base).reshape(-1)
    gs = peb.reshape(B * N, 2 * d)[s] * s_ok
    gate = pd.reshape(B * N, d)[r] * r_ok + gs[:, :d] + ce.reshape(-1, d)
    sig = torch.sigmoid(gate)
    w = emask.reshape(-1, 1).to(pd.dtype) * r_ok
    nd = torch.zeros((B * N, 2 * d), dtype=pd.dtype, device=pd.device).index_add(
        0, r, w * torch.cat([sig * gs[:, d:], sig], dim=1))
    return gate.reshape(ce.shape), nd.reshape(B, N, 2 * d)


def edge_gate_backward_plain(pd, peb, ce, s_loc, r_loc, emask, gg, gnd):
    """Plain version of :func:`edge_gate_backward`, same signature (without
    ``kept``): autograd through :func:`edge_gate_plain`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (pd, peb, ce)]
        outs = edge_gate_plain(*ins, s_loc, r_loc, emask)
        return torch.autograd.grad(outs, ins, (gg, gnd))


def _check_args(pd, peb, ce, s_loc, r_loc, emask):
    """Raise unless the arguments are what the kernels take; returns
    (B, N, E, d, device)."""
    B, N, d = pd.shape
    E = ce.shape[1]
    dev = pd.device
    smem = build.cfunc("edge_gate", "edge_gate_smem", [ctypes.c_int],
                       ctypes.c_longlong)(N)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_edge_gate: N={N} node slots per graph need {smem} bytes "
            f"of shared memory a block, beyond the card's {SMEM_LIMIT}")
    build.require("pd", pd, (B, N, d), dev)
    build.require("peb", peb, (B, N, 2 * d), dev)
    build.require("ce", ce, (B, E, d), dev)
    build.require("s_loc", s_loc, (B, E), dev, torch.int32)
    build.require("r_loc", r_loc, (B, E), dev, torch.int32)
    build.require("emask", emask, (B, E), dev)
    return B, N, E, d, dev


def _launch_forward(args):
    """The forward kernel: (gate, nd)."""
    B, N, E, d, dev = _check_args(*args)
    gate = torch.empty_like(args[2])
    nd = torch.empty((B, N, 2 * d), device=dev, dtype=torch.float32)
    fn = build.cfunc("edge_gate", "edge_gate_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (gate, nd)), B, N, E, d,
             build.stream_of(dev))
    build.check_launch("fused_edge_gate", err)
    fused_edge_gate.launches += 1
    return gate, nd


def edge_gate_backward(pd, peb, ce, s_loc, r_loc, emask, gg, gnd, kept=None):
    """The backward of :func:`fused_edge_gate` given the cotangents of its
    two outputs (gg like gate, gnd like nd): returns (dpd, dpeb, dce). CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    also takes the forward kernel's ``kept`` gate."""
    inputs = (pd, peb, ce, s_loc, r_loc, emask)
    if pd.device.type == "cpu":
        return edge_gate_backward_plain(*inputs, gg, gnd)
    if pd.device.type != "cuda" or kept is None:
        raise ValueError(f"edge_gate_backward: unsupported device "
                         f"{pd.device}, or no kept gate")
    B, N, E, d, dev = _check_args(*inputs)
    (gate,) = kept
    for name, t in (("gate", gate), ("gg", gg)):
        build.require(name, t, (B, E, d), dev)
    build.require("gnd", gnd, (B, N, 2 * d), dev)
    dpd, dpeb, dce = (torch.empty_like(t) for t in (pd, peb, ce))
    fn = build.cfunc("edge_gate", "edge_gate_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (peb, gate, s_loc, r_loc, emask, gg, gnd, dpd,
                              dpeb, dce)), B, N, E, d, build.stream_of(dev))
    build.check_launch("edge_gate_backward", err)
    edge_gate_backward.launches += 1
    return dpd, dpeb, dce


class _EdgeGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        gate, nd = _launch_forward(args)
        ctx.save_for_backward(*args, gate)
        return gate, nd

    @staticmethod
    def backward(ctx, gg, gnd):
        saved = ctx.saved_tensors
        grads = edge_gate_backward(*saved[:6], gg.contiguous(),
                                   gnd.contiguous(), kept=saved[6:])
        return (*grads, None, None, None)


def fused_edge_gate(pd, peb, ce, s_loc, r_loc, emask):
    """pd: (B, N, d) the receiver projection D x; peb: (B, N, 2d) the sender
    projections [E x | B x]; ce: (B, E, d) the edge projection; s_loc/r_loc:
    (B, E) int32 graph-local endpoints; emask: (B, E) float 1/0.

    Returns (gate (B, E, d) = ``pd[r] + peb[s, :d] + ce``, nd (B, N, 2d) =
    ``[Σ m σ(gate)·peb[s, d:] | Σ m σ(gate)]`` per receiver); the caller
    forms ``x_new = A x + num / (den + 1e-6)``. pd, peb and ce get
    gradients. CPU tensors take the plain version (autograd differentiates
    it); CUDA tensors launch the kernel, and the backward kernel when
    differentiated."""
    args = (pd, peb, ce, s_loc, r_loc, emask)
    if pd.device.type == "cpu":
        return edge_gate_plain(*args)
    if pd.device.type != "cuda":
        raise ValueError(f"fused_edge_gate: unsupported device {pd.device}")
    if not needs_grad(*args):
        return _launch_forward(args)
    return _EdgeGate.apply(*args)


fused_edge_gate.launches = 0
edge_gate_backward.launches = 0
