"""Segment reductions over the flat edge list of a padded batch
(counterpart of ``graphgps_tpu/ops/segment.py``: ``segment_sum`` :158,
``blocked_segment_sum`` :64 and ``blocked_gather`` :91, ``gather`` :371
with ``_sorted_bwd_take`` :335 and ``in_degree`` :394).

JAX picks among five forms of the same sum by the TPU's layout, in this
order (:func:`segment_rung`): blocked (per-graph one-hot matmuls,
``_blocked_ok``), dense (one (E, S) one-hot matmul), tiled
(``tiled_segment_sum`` where ``tiled_eligible``), CSR (``segment_sum_csr``
under ``GGPS_USE_CSR_KERNEL=1`` on the TPU) and XLA's scatter. The port
takes the same rung under the same switches and sizes: the blocked rung is
JAX's per-graph one-hot products (``torch.bmm`` in f32: fixed-order sums,
the same bits run after run, where ``index_add_`` on the card adds with
atomics); on the card the tiled and CSR rungs launch their kernels
(``kernels/segment_sum.py``) and the dense and scatter rungs are one
``index_add_``; on the CPU the CSR rung is never taken and the tiled one
only under ``GGPS_TILED_FORCE=1`` (as JAX off the TPU), through the
kernel's plain version. The backward of every rung but the blocked one is
the gather ``index_select``. A gather in the blocked layout is JAX's
``blocked_gather``, its backward the blocked sum; elsewhere the gather's
backward takes the tiled rung where JAX's ``_sbt_bwd`` does,
``index_add_`` otherwise. The blocked rung keeps JAX's precondition: an
edge slot's id lies in its graph's node range (the loader's layout), and
one outside it adds nowhere. The tiled and CSR rungs
build one plan per id tensor (``kernels/segment_sum.py`` ``plan_for``): a
GCN step over a batch builds the receivers' and, in its backward, the
senders', whatever its depth, as JAX sorts once per batch.

JAX's switches, under their names and read when JAX reads them: at import
``GGPS_DENSE_SEGMENT_LIMIT`` and ``GGPS_BLOCKED_LIMIT``; per call
``GGPS_TILED_SEGMENT``, ``GGPS_TILED_FORCE``, ``GGPS_USE_CSR_KERNEL`` and
``GGPS_SORTED_TAKE``. JAX's tuning knobs of its TPU layout
(``GGPS_TILED_NB``, ``GGPS_BLOCKED_GATHER``) are not mirrored: the port
takes their defaults.

Masked entries (padded edges) count as zero; repeated (sender, receiver)
pairs count once each, as in JAX."""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .kernels.common import needs_grad

# the dense one-hot rung up to E * S entries (segment.py:28)
DENSE_LIMIT = int(os.environ.get("GGPS_DENSE_SEGMENT_LIMIT", 1 << 23))
# the blocked rung up to edge_block * max_nodes entries (segment.py:119)
BLOCKED_LIMIT = int(os.environ.get("GGPS_BLOCKED_LIMIT", str(1 << 21)))


def _blocked_ok(edge_block: int, max_nodes: int) -> bool:
    return edge_block * max_nodes <= BLOCKED_LIMIT


def _blocked(E: int, S: int, edge_block, max_nodes) -> bool:
    """The blocked layout's conditions of ``segment_sum`` and ``gather``
    (segment.py:169-172, :381-385), floating data aside."""
    return bool(edge_block and max_nodes and _blocked_ok(edge_block, max_nodes)
                and E % edge_block == 0
                and S == (E // edge_block) * max_nodes)


def has_nb(S: int) -> bool:
    """Whether JAX's ``_pick_nb`` (segment_tiled.py:55) finds an output
    block: a multiple of 8 up to 512 that divides S. The port's kernel has
    no output blocks; the rung takes it as JAX's condition."""
    return any(S % nb == 0 for nb in range(8, min(S, 512) + 1, 8))


def tiled_eligible(E: int, S: int, d: int, device_type: str) -> bool:
    """``tiled_eligible`` (segment_tiled.py:184): opt-in by
    ``GGPS_TILED_SEGMENT=1``; off the card only under ``GGPS_TILED_FORCE=1``
    (JAX: off the TPU); E ≥ 16,384, d ≥ 16, S ≥ 512 and :func:`has_nb`."""
    if os.environ.get("GGPS_TILED_SEGMENT", "0") != "1":
        return False
    if device_type != "cuda" and os.environ.get("GGPS_TILED_FORCE") != "1":
        return False
    return E >= 16384 and d >= 16 and S >= 512 and has_nb(S)


def segment_rung(shape, floating: bool, num_segments: int, device_type: str,
                 edge_block: Optional[int] = None,
                 max_nodes: Optional[int] = None) -> str:
    """The rung ("blocked", "dense", "tiled", "csr" or "scatter") JAX's
    ``segment_sum`` takes for data of ``shape`` (floating or not) into
    ``num_segments``, on the card (``device_type`` "cuda") where JAX is on
    the TPU."""
    E, S = shape[0], num_segments
    if floating and _blocked(E, S, edge_block, max_nodes):
        return "blocked"
    if E * S <= DENSE_LIMIT and floating:
        return "dense"
    if floating and tiled_eligible(E, S, math.prod(shape[1:]), device_type):
        return "tiled"
    if (os.environ.get("GGPS_USE_CSR_KERNEL", "0") == "1" and floating
            and len(shape) == 2 and S % 128 == 0 and device_type == "cuda"):
        return "csr"
    return "scatter"


def _block_onehot(ids, edge_block: int, max_nodes: int, dtype):
    """(B, max_nodes, edge_block) one-hot of each edge slot's graph-local
    id (JAX's ``_block_onehot``, transposed)."""
    B = ids.shape[0] // edge_block
    base = torch.arange(B, device=ids.device)[:, None] * max_nodes
    local = ids.reshape(B, edge_block).long() - base
    nodes = torch.arange(max_nodes, device=ids.device)
    return (local[:, None, :] == nodes[None, :, None]).to(dtype)


def blocked_segment_sum(data, segment_ids, edge_block: int, max_nodes: int):
    """The blocked rung: per graph, the (max_nodes, edge_block) one-hot of
    its edges' local ids times their rows; autograd's backward is the
    transposed product (JAX's ``blocked_segment_sum``)."""
    B = data.shape[0] // edge_block
    oh = _block_onehot(segment_ids, edge_block, max_nodes, data.dtype)
    out = torch.bmm(oh, data.reshape(B, edge_block, -1))
    return out.reshape(B * max_nodes, *data.shape[1:])


def blocked_gather(x, idx, edge_block: int, max_nodes: int):
    """Rows ``x[idx]`` in the blocked layout as per-graph one-hot products
    (exact: one row selected per output row); the backward is the blocked
    sum (JAX's ``blocked_gather``)."""
    B = idx.shape[0] // edge_block
    oh = _block_onehot(idx, edge_block, max_nodes, x.dtype)
    out = torch.bmm(oh.transpose(1, 2), x.reshape(B, max_nodes, -1))
    return out.reshape(idx.shape[0], *x.shape[1:])


def _index_add(data, segment_ids, num_segments: int):
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_sum(data, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None,
                edge_block: Optional[int] = None,
                max_nodes: Optional[int] = None):
    """Sum of ``data`` (E, ...) rows into ``num_segments`` rows by
    ``segment_ids`` (E,); rows where ``mask`` is False add nothing. The
    rung is :func:`segment_rung`'s; ``edge_block`` and ``max_nodes`` are
    the batch's blocked layout, as JAX's callers pass them."""
    from .kernels import segment_sum as kseg

    rung = segment_rung(tuple(data.shape), data.is_floating_point(),
                        num_segments, data.device.type, edge_block, max_nodes)
    if mask is not None:
        data = torch.where(mask.reshape(-1, *[1] * (data.ndim - 1)), data, 0)
    if rung == "blocked":
        return blocked_segment_sum(data, segment_ids, edge_block, max_nodes)
    if rung == "tiled":
        flat = data.reshape(data.shape[0], -1).float().contiguous()
        out = kseg.tiled_segment_sum(flat, segment_ids.to(torch.int32),
                                     num_segments)
        return out.reshape(num_segments, *data.shape[1:]).to(data.dtype)
    if rung == "csr":   # the pointers are the receivers' plan's
        return kseg.segment_sum_csr(data.contiguous(), segment_ids, None,
                                    num_segments)
    return _index_add(data, segment_ids, num_segments)


def sorted_take_backward(g, idx, num_rows: int):
    """The backward of a gather ``x[idx]`` into ``num_rows`` rows (JAX's
    ``_sbt_bwd``, segment.py:352): the tiled rung where
    :func:`tiled_eligible`, else ``index_add_`` (JAX's sorted scatter: the
    same sums in the same order)."""
    from .kernels import segment_sum as kseg

    if g.dim() == 2 and tiled_eligible(g.shape[0], num_rows, g.shape[1],
                                       g.device.type):
        return kseg.tiled_segment_sum(
            g.float().contiguous(), idx.to(torch.int32), num_rows).to(g.dtype)
    return _index_add(g, idx, num_rows)


class _SortedBwdTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return sorted_take_backward(g.contiguous(), idx, ctx.num_rows), None


def gather(x, idx, edge_block: Optional[int] = None,
           max_nodes: Optional[int] = None):
    """Rows ``x[idx]``: a neighbour's features per edge. In the blocked
    layout (float ``x``) :func:`blocked_gather`, as JAX's default
    ``GGPS_BLOCKED_GATHER``; where JAX takes ``_sorted_bwd_take`` (float 2-D
    ``x``, 4,096 indices or more, ``GGPS_SORTED_TAKE`` not 0) the backward
    is :func:`sorted_take_backward`; elsewhere autograd's ``index_add_``."""
    floating = x.is_floating_point()
    if floating and _blocked(idx.shape[0], x.shape[0], edge_block,
                             max_nodes):
        return blocked_gather(x, idx, edge_block, max_nodes)
    if (floating and x.dim() == 2 and idx.shape[0] >= 4096
            and os.environ.get("GGPS_SORTED_TAKE", "1") == "1"
            and needs_grad(x)):
        return _SortedBwdTake.apply(x, idx)
    return x.index_select(0, idx.long())


def in_degree(receivers, num_segments: int,
              mask: Optional[torch.Tensor] = None):
    """Real edges into each node, as float32."""
    ones = torch.ones(receivers.shape[0], dtype=torch.float32,
                      device=receivers.device)
    return segment_sum(ones, receivers, num_segments, mask)
