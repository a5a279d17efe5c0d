"""Node/edge feature encoders of the main path: Atom, Bond and RWSE, and
their composition.

Counterparts: ``graphgps_tpu/models/encoders.py`` (``AtomEncoder`` :43,
``BondEncoder`` :116, ``KernelPENodeEncoder``/RWSE :199-230) and
``graphgps_tpu/models/networks.py:80-132`` ``FeatureEncoder``: the dataset
encoder embeds into ``d − dim_pe`` channels, the PE encoder appends its
``dim_pe``, and padded node slots are zeroed.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import parse_times_func
from ..data.graph import GraphBatch
from .common import MaskedBatchNorm

# OGB molecule feature cardinalities (ogb.utils.features)
ATOM_FEATURE_DIMS = [119, 5, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]


class _SumEmbedding(nn.Module):
    """Sum of one embedding per integer feature column; a column's codes
    are clipped to its table. A batch with fewer columns than tables (the
    synthetic molecules carry one) uses the first tables only."""

    def __init__(self, cardinalities, dim_emb: int):
        super().__init__()
        self.cardinalities = list(cardinalities)
        self.embeddings = nn.ModuleList(nn.Embedding(c, dim_emb)
                                        for c in cardinalities)

    def forward(self, feats):
        out = 0.0
        for i in range(min(feats.shape[1], len(self.embeddings))):
            idx = feats[:, i].long().clamp(0, self.cardinalities[i] - 1)
            out = out + self.embeddings[i](idx)
        return out


class AtomEncoder(_SumEmbedding):
    def __init__(self, dim_emb: int):
        super().__init__(ATOM_FEATURE_DIMS, dim_emb)


class BondEncoder(_SumEmbedding):
    def __init__(self, dim_emb: int):
        super().__init__(BOND_FEATURE_DIMS, dim_emb)


class RWSENodeEncoder(nn.Module):
    """Raw BatchNorm over the RWSE statistics → Linear → append."""

    def __init__(self, num_steps: int, dim_pe: int,
                 raw_norm_type: str = "BatchNorm"):
        super().__init__()
        self.raw_norm = (MaskedBatchNorm(num_steps)
                         if raw_norm_type.lower() == "batchnorm" else None)
        self.proj = nn.Linear(num_steps, dim_pe)

    def forward(self, batch: GraphBatch, x):
        pos = batch.pe["pestat_RWSE"].float()
        if self.raw_norm is not None:
            pos = self.raw_norm(pos, batch.node_mask)
        pe = self.proj(pos)
        return torch.cat([x, pe], dim=-1) if x is not None else pe


class FeatureEncoder(nn.Module):
    """Atom+RWSE node encoder and Bond edge encoder of the PCQM4Mv2 recipe."""

    def __init__(self, cfg, dim_h: int):
        super().__init__()
        ds = cfg.dataset
        if not (ds.node_encoder and ds.node_encoder_name == "Atom+RWSE"
                and ds.edge_encoder and ds.edge_encoder_name == "Bond"
                and not ds.node_encoder_bn and not ds.edge_encoder_bn
                and cfg.posenc_RWSE.model == "Linear"):
            raise NotImplementedError(
                f"encoders {ds.node_encoder_name!r}/{ds.edge_encoder_name!r} "
                f"(RWSE model {cfg.posenc_RWSE.model!r}): the port has Atom+RWSE"
                " with a Linear RWSE and Bond only (ROADMAP Queue 1 items 12 "
                "and 16)")
        p = cfg.posenc_RWSE
        times = p.kernel.times or parse_times_func(p.kernel.times_func)
        self.atom = AtomEncoder(dim_h - p.dim_pe)
        self.rwse = RWSENodeEncoder(len(times), p.dim_pe, p.raw_norm_type)
        self.bond = BondEncoder(dim_h)

    def forward(self, batch: GraphBatch):
        x = self.rwse(batch, self.atom(batch.node_feat))
        e = self.bond(batch.edge_feat)
        x = torch.where(batch.node_mask[:, None], x, 0.0)
        return x, e
