"""Segmented row sums, forward only: the CUDA kernel of
``csrc/segment_sum.cu`` behind two wrappers, and their plain PyTorch
versions.

- :func:`segment_sum_csr` replaces ``graphgps_tpu/ops/pallas/
  segment_csr.py:155`` ``segment_sum_csr``: rows sorted by segment and the
  CSR pointers ``row_ptr`` (:func:`row_ptr_from_sorted`, computed outside
  the kernel as JAX computes them outside its own).
- :func:`tiled_segment_sum` replaces ``graphgps_tpu/ops/pallas/
  segment_tiled.py:100`` ``tiled_segment_sum``: unsorted ids; a stable
  argsort and the CSR pointers over the sorted ids run outside the kernel
  (JAX's ``_prep`` runs them in XLA), and the kernel reads the data rows in
  place through the permutation.

Both backwards are the row gather ``g[ids]`` (``index_select``), as JAX's
are (``jnp.take``): no kernel. Each sum adds a segment's rows in edge order
from 0, as a sequential ``index_add_`` does."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import needs_grad

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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


def _segments_of(ptr, num_segments: int):
    """The segment of each position of a CSR list: (E,) int64."""
    return torch.repeat_interleave(
        torch.arange(num_segments, device=ptr.device), ptr.diff().long())


def segment_sum_csr_plain(data, receivers, row_ptr, num_segments: int):
    """Plain version of :func:`segment_sum_csr`, same signature: the rows
    summed into the segments ``row_ptr`` gives them. Raises unless
    ``receivers`` is sorted (the kernel reads ``row_ptr`` alone)."""
    if bool((receivers[1:] < receivers[:-1]).any()):
        raise ValueError("segment_sum_csr: receivers must be sorted")
    seg = _segments_of(row_ptr, num_segments)
    return data.new_zeros((num_segments, data.shape[1])).index_add_(
        0, seg, data)


def tiled_segment_sum_plain(data, segment_ids, num_segments: int):
    """Plain version of :func:`tiled_segment_sum`, same signature: the rows
    in sorted order summed into their segments."""
    perm, ptr = tiled_prep(segment_ids, num_segments)
    seg = _segments_of(ptr, num_segments)
    return data.new_zeros((num_segments, data.shape[1])).index_add_(
        0, seg, data[perm.long()])


def _launch(wrapper, data, perm, ptr, num_segments: int):
    E, d = data.shape
    dev = data.device
    build.require("data", data, (E, d), dev)
    build.require("ptr", ptr, (num_segments + 1,), dev, torch.int32)
    if perm is not None:
        build.require("perm", perm, (E,), dev, torch.int32)
    out = torch.empty((num_segments, d), device=dev)
    vec = int(d % 4 == 0 and data.data_ptr() % 16 == 0)
    fn = build.cfunc("segment_sum", "segment_sum_forward", _ARGTYPES)
    err = fn(build.ptr(data), None if perm is None else build.ptr(perm),
             build.ptr(ptr), build.ptr(out), num_segments, d, vec,
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


def segment_sum_csr(data, receivers, row_ptr, num_segments: int):
    """data: (E, d) f32 with ``receivers`` (E,) sorted; ``row_ptr``: (S + 1,)
    int32 (:func:`row_ptr_from_sorted`). Returns the (S, d) segment sums;
    data gets the gather gradient. CPU tensors take the plain version, which
    raises on unsorted receivers; CUDA tensors launch the kernel after a
    device-side assert of the sort (no host sync: unsorted receivers fail
    the run at its next synchronisation)."""
    if data.device.type == "cpu":
        return _differentiable(lambda x: segment_sum_csr_plain(
            x, receivers, row_ptr, num_segments), data, receivers)
    _check("segment_sum_csr", data, receivers)
    torch._assert_async((receivers[1:] >= receivers[:-1]).all())
    return _differentiable(lambda x: _launch(
        segment_sum_csr, x, None, row_ptr.to(torch.int32).contiguous(),
        num_segments), data, receivers)


def tiled_segment_sum(data, segment_ids, num_segments: int):
    """data: (E, d) f32; segment_ids: (E,) in [0, S), any order (masked
    rows zeroed by the caller). Returns the (S, d) segment sums; data gets
    the gather gradient. CPU tensors take the plain version; CUDA tensors
    launch the kernel after :func:`tiled_prep`."""
    if data.device.type == "cpu":
        return _differentiable(lambda x: tiled_segment_sum_plain(
            x, segment_ids, num_segments), data, segment_ids)
    _check("tiled_segment_sum", data, segment_ids)

    def forward(x):
        perm, ptr = tiled_prep(segment_ids, num_segments)
        return _launch(tiled_segment_sum, x, perm, ptr, num_segments)

    return _differentiable(forward, data, segment_ids)


segment_sum_csr.launches = 0
tiled_segment_sum.launches = 0
