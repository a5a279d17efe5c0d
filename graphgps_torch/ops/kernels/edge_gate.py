"""GatedGCN gather/gate/aggregate middle for long graphs -- the gathers by
sender and receiver, the gate, and the masked num/den aggregation, from
projections the caller computed: the CUDA kernels of ``csrc/edge_gate.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_edge_gate.py:120``
``fused_edge_gate`` and its backward ``_vjp_bwd`` :167) and their plain
PyTorch versions. The kernels take the edge axis as it is and the true width:
the TPU's (B, T, 128) edge tiles and its zero-padding to 128 lanes have no
counterpart.

The kernels walk a batch's edges in two orders (:class:`EdgeOrders`): by
receiver and by sender, each a stable sort of the B*E edges by ``g*N +
endpoint`` with CSR offsets over the B*N node slots (an endpoint outside
``[0, N)`` goes to a sink segment after them). They are built once per
batch (``GraphBatch.edge_gate_orders``, beside ``front_index``) and shared
by every layer's forward and backward calls; a call given no orders builds
its own. Both orders are one sort: the receivers' keys and, after them, the
senders' offset by B*N + 1, so that on the card they take one stable
``torch.argsort`` and one launch of the segment sums' plan kernel
(``segment_sum.segment_plan``); on the CPU its plain version."""
from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Optional

import torch

from . import build
from .common import needs_grad
from .segment_sum import SegmentPlan, segment_plan

_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# positions of the differentiable inputs among the six
GRAD_INPUTS = (0, 1, 2)   # pd, peb, ce


@dataclasses.dataclass
class EdgeOrders:
    """A batch's edges by receiver and by sender, as one
    :class:`SegmentPlan` over 2 (B*N + 1) segments of the keys ``g*N +
    r_loc`` (B*E of them, ``B*N`` for a receiver outside ``[0, N)``) and,
    after them, ``B*N + 1 + g*N + s_loc`` (``2 B*N + 1`` outside). Its
    ``perm`` (2 B*E,) int32 lists the receiver order's flat edge numbers,
    then the sender order's plus B*E; ``ptr`` (2 B*N + 3,) int32 the
    offsets: ``recv_ptr`` = ``ptr[:B*N + 1]`` (``recv_ptr[B*N]``: the first
    sink edge), ``send_ptr`` = ``ptr[B*N + 1:]``, positions in ``perm``.
    Tied to the index tensors it was built from, as they were then
    (:meth:`fits`)."""

    s_loc: weakref.ref
    r_loc: weakref.ref
    versions: tuple
    num_nodes: int
    plan: SegmentPlan

    def fits(self, s_loc, r_loc, num_nodes: int) -> bool:
        """Whether these are the orders of ``s_loc`` and ``r_loc`` as they
        are now, at ``num_nodes`` node slots a graph."""
        return (self.s_loc() is s_loc and self.r_loc() is r_loc
                and self.versions == (s_loc._version, r_loc._version)
                and self.num_nodes == num_nodes)

    @property
    def perm(self):
        return self.plan.perm

    @property
    def recv_ptr(self):
        return self.plan.ptr[:self.plan.num_segments // 2]

    @property
    def send_ptr(self):
        return self.plan.ptr[self.plan.num_segments // 2:]

    def order(self, by_sender: bool):
        """(perm (B*E,), ptr (B*N + 1,)) of one order alone, edge numbers
        and positions counted from its own start (for checks; the kernels
        read the joint arrays)."""
        E2, S1 = self.plan.num_edges, self.plan.num_segments // 2
        if not by_sender:
            return self.perm[:E2 // 2], self.recv_ptr
        return (self.perm[E2 // 2:] - E2 // 2,
                self.plan.ptr[S1:2 * S1] - E2 // 2)


def order_keys(s_loc, r_loc, num_nodes: int):
    """(2 B*E,) int32 keys of both orders: ``g*N + r_loc`` (``B*N`` where
    r_loc lies outside ``[0, N)``), then ``B*N + 1 + g*N + s_loc``
    (``2 B*N + 1`` outside)."""
    B, N = s_loc.shape[0], num_nodes
    S = B * N
    loc = torch.stack([r_loc, s_loc]).to(torch.int32)
    base = (torch.arange(2, device=loc.device, dtype=torch.int32)[:, None, None]
            * (S + 1)
            + torch.arange(B, device=loc.device, dtype=torch.int32)[:, None]
            * N)
    sink = base[:, :1] + S
    ok = (loc >= 0) & (loc < N)
    return torch.where(ok, loc + base, sink).reshape(-1)


def edge_gate_orders(s_loc, r_loc, num_nodes: int) -> EdgeOrders:
    """Both edge orders of graph-local endpoints ``s_loc``/``r_loc`` (B, E)
    int32 at ``num_nodes`` node slots a graph. CUDA tensors launch the plan
    kernel once (``segment_plan.launches``), after one stable argsort; CPU
    tensors take its plain version."""
    S = s_loc.shape[0] * num_nodes
    plan = segment_plan(order_keys(s_loc, r_loc, num_nodes), 2 * (S + 1),
                        tiled=True)
    return EdgeOrders(weakref.ref(s_loc), weakref.ref(r_loc),
                      (s_loc._version, r_loc._version), num_nodes, plan)


def _orders(orders: Optional[EdgeOrders], s_loc, r_loc, num_nodes: int):
    if orders is None:
        return edge_gate_orders(s_loc, r_loc, num_nodes)
    if not orders.fits(s_loc, r_loc, num_nodes):
        raise ValueError("edge gate: the orders were built from other "
                         "endpoints, or before they changed")
    return orders


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
    ``kept`` and ``orders``): autograd through :func:`edge_gate_plain`."""
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
    build.require("pd", pd, (B, N, d), dev)
    build.require("peb", peb, (B, N, 2 * d), dev)
    build.require("ce", ce, (B, E, d), dev)
    build.require("s_loc", s_loc, (B, E), dev, torch.int32)
    build.require("r_loc", r_loc, (B, E), dev, torch.int32)
    build.require("emask", emask, (B, E), dev)
    return B, N, E, d, dev


def _launch_forward(args, orders: Optional[EdgeOrders] = None):
    """The forward kernel: (gate, nd), walking the receiver order of
    ``orders`` (built here when None)."""
    B, N, E, d, dev = _check_args(*args)
    pd, peb, ce, s_loc, r_loc, emask = args
    orders = _orders(orders, s_loc, r_loc, N)
    gate = torch.empty_like(ce)
    nd = torch.empty((B, N, 2 * d), device=dev, dtype=torch.float32)
    fn = build.cfunc("edge_gate", "edge_gate_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (pd, peb, ce, s_loc, emask, orders.perm,
                              orders.recv_ptr, gate, nd)), B, N, E, d,
             build.stream_of(dev))
    build.check_launch("fused_edge_gate", err)
    fused_edge_gate.launches += 1
    return gate, nd


def edge_gate_backward(pd, peb, ce, s_loc, r_loc, emask, gg, gnd, kept=None,
                       orders: Optional[EdgeOrders] = None):
    """The backward of :func:`fused_edge_gate` given the cotangents of its
    two outputs (gg like gate, gnd like nd): returns (dpd, dpeb, dce). CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    also takes the forward kernel's ``kept`` gate, and walks both orders of
    ``orders`` (built here when None)."""
    inputs = (pd, peb, ce, s_loc, r_loc, emask)
    if pd.device.type == "cpu":
        return edge_gate_backward_plain(*inputs, gg, gnd)
    if pd.device.type != "cuda" or kept is None:
        raise ValueError(f"edge_gate_backward: unsupported device "
                         f"{pd.device}, or no kept gate")
    B, N, E, d, dev = _check_args(*inputs)
    orders = _orders(orders, s_loc, r_loc, N)
    (gate,) = kept
    for name, t in (("gate", gate), ("gg", gg)):
        build.require(name, t, (B, E, d), dev)
    build.require("gnd", gnd, (B, N, 2 * d), dev)
    dpd, dpeb, dce = (torch.empty_like(t) for t in (pd, peb, ce))
    fn = build.cfunc("edge_gate", "edge_gate_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (peb, gate, s_loc, r_loc, emask, orders.perm,
                              orders.recv_ptr, orders.send_ptr, gg, gnd, dpd,
                              dpeb, dce)), B, N, E, d, build.stream_of(dev))
    build.check_launch("edge_gate_backward", err)
    edge_gate_backward.launches += 1
    return dpd, dpeb, dce


class _EdgeGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, orders = inputs[:6], inputs[6]
        orders = _orders(orders, args[3], args[4], args[0].shape[1])
        gate, nd = _launch_forward(args, orders)
        ctx.save_for_backward(*args, gate)
        ctx.orders = orders
        return gate, nd

    @staticmethod
    def backward(ctx, gg, gnd):
        saved = ctx.saved_tensors
        grads = edge_gate_backward(*saved[:6], gg.contiguous(),
                                   gnd.contiguous(), kept=saved[6:],
                                   orders=ctx.orders)
        return (*grads, None, None, None, None)


def fused_edge_gate(pd, peb, ce, s_loc, r_loc, emask,
                    orders: Optional[EdgeOrders] = None):
    """pd: (B, N, d) the receiver projection D x; peb: (B, N, 2d) the sender
    projections [E x | B x]; ce: (B, E, d) the edge projection; s_loc/r_loc:
    (B, E) int32 graph-local endpoints; emask: (B, E) float 1/0; ``orders``:
    the endpoints' :class:`EdgeOrders` (the batch's, shared by its layers),
    or None to build them for this call alone.

    Returns (gate (B, E, d) = ``pd[r] + peb[s, :d] + ce``, nd (B, N, 2d) =
    ``[Σ m σ(gate)·peb[s, d:] | Σ m σ(gate)]`` per receiver); the caller
    forms ``x_new = A x + num / (den + 1e-6)``. pd, peb and ce get
    gradients. CPU tensors take the plain version (autograd differentiates
    it; given orders are checked, not read); CUDA tensors launch the kernel,
    and the backward kernels when differentiated. Orders built from other
    endpoints, or before they changed, raise."""
    args = (pd, peb, ce, s_loc, r_loc, emask)
    if orders is not None:
        _orders(orders, s_loc, r_loc, pd.shape[1])
    if pd.device.type == "cpu":
        return edge_gate_plain(*args)
    if pd.device.type != "cuda":
        raise ValueError(f"fused_edge_gate: unsupported device {pd.device}")
    if not needs_grad(*args):
        return _launch_forward(args, orders)
    return _EdgeGate.apply(*args, orders)


fused_edge_gate.launches = 0
edge_gate_backward.launches = 0
