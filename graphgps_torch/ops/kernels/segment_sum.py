"""Segmented row sums, forward only: the CUDA kernel of
``csrc/segment_sum.cu`` behind two wrappers, the plan of an id vector that
both read, and their plain PyTorch versions.

- :func:`segment_sum_csr` replaces ``graphgps_tpu/ops/pallas/
  segment_csr.py:155`` ``segment_sum_csr``: rows sorted by segment and the
  CSR pointers ``row_ptr`` (:func:`row_ptr_from_sorted`, or the plan's).
- :func:`tiled_segment_sum` replaces ``graphgps_tpu/ops/pallas/
  segment_tiled.py:100`` ``tiled_segment_sum``: unsorted ids, read in place
  through a stable argsort (JAX's ``_prep`` runs it in XLA).

The plan (:class:`SegmentPlan`) holds what the sums need beside the data:
the CSR pointers, the permutation (tiled), and the kernel's task state (the
segments each chunk of ``TASK_LEN`` sorted edges meets at its ends, a
ticket per segment). JAX sorts once per batch and shares the result across the step's
segment ops; here :func:`plan_for` builds a plan at the first sum over an id
tensor and keeps it on that tensor, keyed by its ``_version``: every sum and
gather backward over the same ids (a batch's senders or receivers) reuses
it, and a new batch's ids or an in-place edit build a new one. On the card
a plan is one launch of the plan kernel (after ``torch.argsort`` for the
tiled rung); on the CPU its plain version, :func:`plan_plain`.

Both backwards are the row gather ``g[ids]`` (``index_select``), as JAX's
are (``jnp.take``): no kernel. The kernel adds a segment's rows in a fixed
order (four rows at a time, a hub's pieces in chunk order): two runs give
the same bits, within rounding of a sequential ``index_add_``."""
from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Optional

import torch

from . import build
from .common import needs_grad

# edges a warp task sums at most: a longer segment is split across warps
# (chosen on the H100 with graphgps_torch/tools/segment_sweep.py)
TASK_LEN = 64

_SUM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_PLAN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def row_ptr_from_sorted(receivers, num_segments: int):
    """(S + 1,) int32 CSR offsets of sorted ``receivers``
    (``row_ptr_from_sorted``, ``segment_csr.py:172``)."""
    bounds = torch.arange(num_segments + 1, device=receivers.device,
                          dtype=receivers.dtype)
    return torch.searchsorted(receivers, bounds, out_int32=True)


def tiled_prep(segment_ids, num_segments: int):
    """(perm (E,) int32, ptr (S + 1,) int32): a stable argsort of the ids
    and the CSR offsets of the sorted ids (``_prep``, ``segment_tiled.py
    :108``, without its TPU tile tables)."""
    perm = torch.argsort(segment_ids, stable=True)
    ptr = row_ptr_from_sorted(segment_ids[perm], num_segments)
    return perm.to(torch.int32), ptr


def _require_sorted(receivers) -> None:
    if bool((receivers[1:] < receivers[:-1]).any()):
        raise ValueError("segment_sum_csr: receivers must be sorted")


@dataclasses.dataclass
class SegmentPlan:
    """One id vector's preparation for the segment sums. ``perm`` (E,)
    int32: the stable argsort (tiled), else None; ``ptr`` (S + 1,) int32:
    the CSR offsets of the sorted ids; ``chunk_seg`` (cdiv(E, task_len),
    2) int32: the segments of chunk k's first and last edges in the sorted
    list (-1 for the last where it is the first's); ``tickets`` (S,) int32
    the kernel's, zero between its calls (None on the CPU). A plan's sums
    run one at a time, on one stream (its tickets)."""

    ids: weakref.ref
    version: int
    num_edges: int
    num_segments: int
    tiled: bool
    task_len: int
    perm: Optional[torch.Tensor]
    ptr: torch.Tensor
    chunk_seg: torch.Tensor
    tickets: Optional[torch.Tensor]

    def fits(self, ids, num_segments: int, tiled: bool) -> bool:
        """Whether this is the plan of ``ids`` as they are now."""
        return (self.ids() is ids and self.version == ids._version
                and self.num_segments == num_segments and self.tiled == tiled)


def plan_plain(ids, num_segments: int, tiled: bool,
               task_len: int = TASK_LEN):
    """Plain version of the plan kernel: (perm or None, ptr, chunk_seg) of
    :class:`SegmentPlan`. CSR ids must be sorted (raises otherwise)."""
    if tiled:
        perm, ptr = tiled_prep(ids, num_segments)
        sids = ids[perm.long()]
    else:
        _require_sorted(ids)
        perm, sids = None, ids
        ptr = row_ptr_from_sorted(ids, num_segments)
    a = torch.arange(0, ids.shape[0], task_len, device=ids.device)
    first = sids[a].long()
    last = sids[(a + task_len).clamp(max=ids.shape[0]) - 1].long()
    inside = lambda v: (v >= 0) & (v < num_segments)  # noqa: E731
    return perm, ptr, torch.stack(
        [torch.where(inside(first), first, -1),
         torch.where(inside(last) & (last != first), last, -1)],
        1).to(torch.int32)


def segment_plan(ids, num_segments: int, tiled: bool,
                 task_len: int = TASK_LEN) -> SegmentPlan:
    """The plan of ``ids`` (E,) into ``num_segments``: sorted ids (CSR) or
    any order (``tiled``). CUDA ids launch the plan kernel (the tiled plan
    after a stable ``torch.argsort``), which asserts the CSR ids' sort on
    the device (no host sync: unsorted ids fail the run at its next
    synchronisation); CPU ids take :func:`plan_plain`."""
    E, S = ids.shape[0], num_segments
    common = dict(ids=weakref.ref(ids), version=ids._version, num_edges=E,
                  num_segments=S, tiled=tiled, task_len=task_len)
    if ids.device.type == "cpu":
        perm, ptr, chunk_seg = plan_plain(ids, S, tiled, task_len)
        return SegmentPlan(**common, perm=perm, ptr=ptr, chunk_seg=chunk_seg,
                           tickets=None)
    if ids.device.type != "cuda" or ids.dim() != 1:
        raise ValueError(f"segment_plan: ids (E,) on the CPU or the card, got "
                         f"{tuple(ids.shape)} on {ids.device}")
    dev = ids.device
    ids32 = ids.to(torch.int32).contiguous()
    perm64 = torch.argsort(ids32, stable=True) if tiled else None
    i32 = dict(device=dev, dtype=torch.int32)
    perm = torch.empty(E, **i32) if tiled else None
    ptr = torch.empty(S + 1, **i32)
    tickets = torch.empty(S, **i32)
    chunk_seg = torch.empty((-(-E // task_len), 2), **i32)
    fn = build.cfunc("segment_sum", "segment_plan", _PLAN_ARGTYPES)
    opt = lambda t: None if t is None else build.ptr(t)  # noqa: E731
    err = fn(build.ptr(ids32), opt(perm64), opt(perm), build.ptr(ptr),
             build.ptr(tickets), build.ptr(chunk_seg), E, S, task_len,
             int(not tiled), build.stream_of(dev))
    build.check_launch("segment_plan", err)
    segment_plan.launches += 1
    return SegmentPlan(**common, perm=perm, ptr=ptr, chunk_seg=chunk_seg,
                       tickets=tickets)


def plan_for(ids, num_segments: int, tiled: bool) -> SegmentPlan:
    """The plan of ``ids`` as they are now: the one kept on the tensor since
    an earlier sum, or a new one (:func:`segment_plan`) kept in its place.
    A plan is keyed by the tensor and its ``_version``, so an in-place edit
    of the ids builds a new one; a new batch brings new id tensors."""
    plans = ids.__dict__.setdefault("_segment_plans", {})
    plan = plans.get((tiled, num_segments))
    if plan is None or not plan.fits(ids, num_segments, tiled):
        plan = segment_plan(ids, num_segments, tiled)
        plans[(tiled, num_segments)] = plan
    return plan


def _plan(plan, ids, num_segments: int, tiled: bool) -> SegmentPlan:
    if plan is None:
        return plan_for(ids, num_segments, tiled)
    if not plan.fits(ids, num_segments, tiled):
        raise ValueError("the plan was built from other ids, or before the "
                         "ids changed")
    return plan


def segment_tasks(plan: SegmentPlan):
    """(segment, lo, hi) int64 of the kernel's pieces of work in launch
    order, from the plan's pointers and chunk table as the kernel reads
    them: for each chunk of ``task_len`` sorted edges, its edges of the
    segments of its first and last edges that hold more than ``task_len``
    edges (split segments); then each other segment whole (empty ones
    included: they write zeros)."""
    C = plan.task_len
    ptr = plan.ptr.long()
    e0, e1 = ptr[:-1], ptr[1:]
    cs = plan.chunk_seg.long()
    k = torch.arange(cs.shape[0], device=ptr.device)[:, None].expand_as(cs)
    s = cs.clamp(min=0)
    work = (cs >= 0) & (e1[s] - e0[s] > C)
    lo = torch.maximum(k * C, e0[s])[work]
    hi = torch.minimum(k * C + C, e1[s])[work]
    whole = (e1 - e0 <= C).nonzero()[:, 0]
    return (torch.cat([s[work], whole]), torch.cat([lo, e0[whole]]),
            torch.cat([hi, e1[whole]]))


def _segments_of(ptr, num_segments: int):
    """The segment of each position of a CSR list: (E,) int64."""
    return torch.repeat_interleave(
        torch.arange(num_segments, device=ptr.device), ptr.diff().long())


def _sum_plain(data, perm, ptr, num_segments: int):
    """The rows (through ``perm`` where given) summed into the segments
    ``ptr`` gives them."""
    rows = data if perm is None else data[perm.long()]
    return data.new_zeros((num_segments, data.shape[1])).index_add_(
        0, _segments_of(ptr, num_segments), rows)


def segment_sum_csr_plain(data, receivers, row_ptr, num_segments: int):
    """Plain version of :func:`segment_sum_csr`, same signature: the rows
    summed into the segments ``row_ptr`` gives them. Raises unless
    ``receivers`` is sorted (the kernel trusts ``row_ptr`` and the plan)."""
    _require_sorted(receivers)
    return _sum_plain(data, None, row_ptr, num_segments)


def tiled_segment_sum_plain(data, segment_ids, num_segments: int):
    """Plain version of :func:`tiled_segment_sum`, same signature: the rows
    in sorted order summed into their segments."""
    perm, ptr = tiled_prep(segment_ids, num_segments)
    return _sum_plain(data, perm, ptr, num_segments)


def _launch(wrapper, data, plan: SegmentPlan, ptr):
    E, d = data.shape
    S, C = plan.num_segments, plan.task_len
    dev = data.device
    build.require("data", data, (E, d), dev)
    build.require("ptr", ptr, (S + 1,), dev, torch.int32)
    if plan.num_edges != E:
        raise ValueError(f"{wrapper.__name__}: a plan of {plan.num_edges} "
                         f"ids for {E} rows")
    out = torch.empty((S, d), device=dev)
    scratch = torch.empty((2 * -(-E // C), d), device=dev)
    vec = int(d % 4 == 0 and data.data_ptr() % 16 == 0)
    fn = build.cfunc("segment_sum", "segment_sum_forward", _SUM_ARGTYPES)
    err = fn(build.ptr(data),
             None if plan.perm is None else build.ptr(plan.perm),
             build.ptr(ptr), build.ptr(plan.chunk_seg),
             build.ptr(plan.tickets), build.ptr(out),
             build.ptr(scratch) if E else None, E, S, d, C, vec,
             build.stream_of(dev))
    build.check_launch(wrapper.__name__, err)
    wrapper.launches += 1
    return out


class _GatherBackward(torch.autograd.Function):
    """A segment sum whose backward is the row gather ``g[ids]``."""

    @staticmethod
    def forward(ctx, data, ids, forward):
        ctx.save_for_backward(ids)
        return forward(data)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return g.index_select(0, ids.long()), None, None


def _differentiable(forward, data, ids):
    if not needs_grad(data):
        return forward(data)
    return _GatherBackward.apply(data, ids, forward)


def _check(name: str, data, ids):
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    if data.dim() != 2 or ids.shape != (data.shape[0],):
        raise ValueError(f"{name}: data (E, d) and ids (E,) expected, got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")


def segment_sum_csr(data, receivers, row_ptr, num_segments: int,
                    plan: Optional[SegmentPlan] = None):
    """data: (E, d) f32 with ``receivers`` (E,) sorted; ``row_ptr``: (S + 1,)
    int32 (:func:`row_ptr_from_sorted`), or None for the plan's. ``plan``:
    the receivers' (:func:`plan_for` when None). Returns the (S, d) segment
    sums; data gets the gather gradient. CPU tensors take the plain version,
    which raises on unsorted receivers; CUDA tensors launch the kernel (the
    plan kernel asserted the sort on the device)."""
    plan = _plan(plan, receivers, num_segments, tiled=False)
    ptr = plan.ptr if row_ptr is None else row_ptr
    if data.device.type == "cpu":
        return _differentiable(lambda x: segment_sum_csr_plain(
            x, receivers, ptr, num_segments), data, receivers)
    _check("segment_sum_csr", data, receivers)
    ptr = ptr.to(torch.int32).contiguous()
    return _differentiable(lambda x: _launch(segment_sum_csr, x, plan, ptr),
                           data, receivers)


def tiled_segment_sum(data, segment_ids, num_segments: int,
                      plan: Optional[SegmentPlan] = None):
    """data: (E, d) f32; segment_ids: (E,) in [0, S), any order (masked
    rows zeroed by the caller); ``plan``: the ids' (:func:`plan_for` when
    None). Returns the (S, d) segment sums; data gets the gather gradient.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    plan = _plan(plan, segment_ids, num_segments, tiled=True)
    if data.device.type == "cpu":
        return _differentiable(lambda x: _sum_plain(
            x, plan.perm, plan.ptr, num_segments), data, segment_ids)
    _check("tiled_segment_sum", data, segment_ids)
    return _differentiable(lambda x: _launch(tiled_segment_sum, x, plan,
                                             plan.ptr), data, segment_ids)


segment_sum_csr.launches = 0
tiled_segment_sum.launches = 0
segment_plan.launches = 0
