"""Segment reductions over the flat edge list of a padded batch
(counterpart of ``graphgps_tpu/ops/segment.py``: ``segment_sum`` :158,
``gather`` :371 and ``in_degree`` :394).

The JAX package picks among blocked, one-hot, tiled and CSR forms of the
same sum by the TPU's layout; on the GPU one ``index_add_`` computes it, and
its backward is the gather ``index_select``. Masked entries (padded edges)
count as zero; repeated (sender, receiver) pairs count once each, as in
JAX."""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None):
    """Sum of ``data`` (E, ...) rows into ``num_segments`` rows by
    ``segment_ids`` (E,); rows where ``mask`` is False add nothing."""
    if mask is not None:
        data = torch.where(mask.reshape(-1, *[1] * (data.ndim - 1)), data, 0)
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def gather(x, idx):
    """Rows ``x[idx]``: a neighbour's features per edge."""
    return x.index_select(0, idx.long())


def in_degree(receivers, num_segments: int,
              mask: Optional[torch.Tensor] = None):
    """Real edges into each node, as float32."""
    ones = torch.ones(receivers.shape[0], dtype=torch.float32,
                      device=receivers.device)
    return segment_sum(ones, receivers, num_segments, mask)
