"""Node/edge feature encoders of the ported paths: Atom and Bond (embedding
sums), VOCNode/LinearNode and VOCEdge/LinearEdge (one Linear over float
features), the RWSE and LapPE encodings, and their composition.

Counterparts: ``graphgps_tpu/models/encoders.py`` (``AtomEncoder`` :43,
``LinearNodeEncoder``/``VOCNodeEncoder`` :58-77, ``BondEncoder`` :116,
``LinearEdgeEncoder`` :128-135, ``KernelPENodeEncoder``/RWSE :199-230,
``LapPENodeEncoder`` :241-332) and ``graphgps_tpu/models/networks.py:80-132``
``FeatureEncoder``: the dataset encoder embeds into ``d − dim_pe`` channels,
the PE encoder appends its ``dim_pe``, and padded node slots are zeroed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import parse_times_func
from ..data.graph import GraphBatch
from .common import MLP, MaskedBatchNorm

# OGB molecule feature cardinalities (ogb.utils.features)
ATOM_FEATURE_DIMS = [119, 5, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]
# float node features of the Linear node encoders: PascalVOC-SP superpixels
# carry 14 (12 colour statistics and 2 coordinates)
VOC_NODE_DIM = 14
VOC_EDGE_DIM = 2


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


class LinearEncoder(nn.Module):
    """One Linear over float features (``VOCNode``/``LinearNode`` on the
    nodes, ``VOCEdge``/``LinearEdge`` on the edges)."""

    def __init__(self, dim_in: int, dim_emb: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_emb)

    def forward(self, feats):
        return self.proj(feats.to(self.proj.weight.dtype))


class RWSENodeEncoder(nn.Module):
    """Raw BatchNorm over the RWSE statistics → Linear → append."""

    def __init__(self, num_steps: int, dim_pe: int,
                 raw_norm_type: str = "BatchNorm"):
        super().__init__()
        self.raw_norm = (MaskedBatchNorm(num_steps)
                         if raw_norm_type.lower() == "batchnorm" else None)
        self.proj = nn.Linear(num_steps, dim_pe)

    def forward(self, batch: GraphBatch, x, gen=None):
        pos = batch.pe["pestat_RWSE"].to(self.proj.weight.dtype)
        if self.raw_norm is not None:
            pos = self.raw_norm(pos, batch.node_mask)
        pe = self.proj(pos)
        return torch.cat([x, pe], dim=-1) if x is not None else pe


def draw_signs(gen: Optional[torch.Generator], K: int):
    """(K,) signs, +1 or -1 with equal chance, from the host generator."""
    if gen is None:
        raise ValueError("training LapPE needs the sign generator")
    return torch.randint(0, 2, (K,), generator=gen) * 2.0 - 1.0


class LapPENodeEncoder(nn.Module):
    """LapPE in its DeepSet form: per node the ``max_freqs`` (eigenvector
    entry, eigenvalue) pairs go through ``layers`` Linears with relu
    (``pre``), the NaN-padded frequencies are masked, the rest summed over
    the frequency axis, then ``post_layers`` more Linears (``post``). In
    training the eigenvectors' signs are flipped at random, one sign per
    frequency, drawn from the host generator. ``raw_norm_type`` BatchNorm
    normalises the raw pairs per frequency over (real nodes × 2)."""

    def __init__(self, dim_pe: int, max_freqs: int, model: str = "DeepSet",
                 layers: int = 2, post_layers: int = 0,
                 raw_norm_type: str = "none"):
        super().__init__()
        if model != "DeepSet":
            raise NotImplementedError(
                f"posenc_LapPE.model={model!r}: the port has the DeepSet "
                "form only (ROADMAP Queue 1 item 16)")
        self.raw_norm = (MaskedBatchNorm(max_freqs)
                         if raw_norm_type.lower() == "batchnorm" else None)
        if layers <= 1:
            dims = [2, dim_pe]
        else:
            dims = [2] + [2 * dim_pe] * (layers - 1) + [dim_pe]
        self.pre = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(dims[:-1], dims[1:]))
        self.post = None
        if post_layers > 0:
            self.post = MLP(dim_pe, 2 * dim_pe, dim_pe,
                            num_layers=post_layers, with_final_act=True)

    def forward(self, batch: GraphBatch, x,
                gen: Optional[torch.Generator] = None):
        dtype = self.pre[0].weight.dtype
        evecs = batch.pe["EigVecs"].to(dtype)                    # (S, K)
        S, K = evecs.shape
        freq_mask = ~torch.isnan(evecs)
        evecs = torch.nan_to_num(evecs)
        if self.training:
            evecs = evecs * draw_signs(gen, K).to(evecs.device)[None, :]
        ev = torch.nan_to_num(batch.extras["EigVals"].to(dtype)).reshape(
            batch.num_graphs, K)
        ev_nodes = ev.repeat_interleave(batch.max_nodes, dim=0)  # (S, K)
        h = torch.stack([evecs, ev_nodes], dim=-1)               # (S, K, 2)
        if self.raw_norm is not None:
            h2 = h.transpose(1, 2).reshape(S * 2, K)
            h2 = self.raw_norm(h2, batch.node_mask.repeat_interleave(2))
            h = h2.reshape(S, 2, K).transpose(1, 2)
        for lin in self.pre:
            h = torch.relu(lin(h))
        pe = torch.where(freq_mask[..., None], h, 0.0).sum(dim=1)
        if self.post is not None:
            pe = self.post(pe)
        return torch.cat([x, pe], dim=-1) if x is not None else pe


NODE_ENCODERS = ("Atom", "VOCNode", "LinearNode")
PE_ENCODERS = ("RWSE", "LapPE")
EDGE_ENCODERS = ("Bond", "VOCEdge", "LinearEdge")


class FeatureEncoder(nn.Module):
    """The dataset's node encoder with one appended encoding, and its edge
    encoder, from ``dataset.node_encoder_name`` (``<node>+<pe>``) and
    ``dataset.edge_encoder_name``: ``Atom+RWSE``/``Bond`` on the molecule
    recipes (modules ``atom``, ``rwse``, ``bond``), ``VOCNode+LapPE``/
    ``VOCEdge`` on the superpixels (``node_lin``, ``lap``, ``edge_lin``)."""

    def __init__(self, cfg, dim_h: int):
        super().__init__()
        ds = cfg.dataset
        node, _, pe = ds.node_encoder_name.partition("+")
        if not (ds.node_encoder and ds.edge_encoder
                and node in NODE_ENCODERS and pe in PE_ENCODERS
                and ds.edge_encoder_name in EDGE_ENCODERS
                and not ds.node_encoder_bn and not ds.edge_encoder_bn
                and (pe != "RWSE" or cfg.posenc_RWSE.model == "Linear")):
            raise NotImplementedError(
                f"encoders {ds.node_encoder_name!r}/{ds.edge_encoder_name!r}: "
                f"the port has one of {NODE_ENCODERS} with one of "
                f"{PE_ENCODERS} (RWSE with a Linear model, LapPE as a "
                f"DeepSet), one of {EDGE_ENCODERS}, and no encoder BatchNorm "
                "(ROADMAP Queue 1 items 12 and 16)")
        p = cfg[f"posenc_{pe}"]
        if node == "Atom":
            self.atom = AtomEncoder(dim_h - p.dim_pe)
        else:
            self.node_lin = LinearEncoder(cfg.share.dim_in or VOC_NODE_DIM,
                                          dim_h - p.dim_pe)
        if pe == "RWSE":
            times = p.kernel.times or parse_times_func(p.kernel.times_func)
            self.rwse = RWSENodeEncoder(len(times), p.dim_pe, p.raw_norm_type)
        else:
            self.lap = LapPENodeEncoder(
                p.dim_pe, p.eigen.max_freqs,
                model=p.model if p.model != "none" else "DeepSet",
                layers=p.layers, post_layers=p.post_layers,
                raw_norm_type=p.raw_norm_type)
        if ds.edge_encoder_name == "Bond":
            self.bond = BondEncoder(dim_h)
        else:
            self.edge_lin = LinearEncoder(VOC_EDGE_DIM, dim_h)
        self.node_name = "atom" if node == "Atom" else "node_lin"
        self.pe_name = "rwse" if pe == "RWSE" else "lap"
        self.edge_name = "bond" if ds.edge_encoder_name == "Bond" else "edge_lin"

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """``gen`` draws LapPE's training sign flip."""
        x = getattr(self, self.node_name)(batch.node_feat)
        x = getattr(self, self.pe_name)(batch, x, gen)
        e = getattr(self, self.edge_name)(batch.edge_feat)
        x = torch.where(batch.node_mask[:, None], x, 0.0)
        return x, e
