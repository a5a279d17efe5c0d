"""Node/edge feature encoders of the ported paths: Atom and Bond (embedding
sums), TypeDictNode (one embedding), VOCNode/LinearNode and VOCEdge/
LinearEdge (one Linear over float features), the RWSE and LapPE encodings,
the Graphormer bias encoder, and their composition.

Counterparts: ``graphgps_tpu/models/encoders.py`` (``TypeDictNodeEncoder``
:29-40, ``AtomEncoder`` :43, ``LinearNodeEncoder``/``VOCNodeEncoder``
:58-77, ``BondEncoder`` :116, ``LinearEdgeEncoder`` :128-135,
``KernelPENodeEncoder``/RWSE :199-230, ``LapPENodeEncoder`` :241-332 (its
Transformer form :295-315),
``GraphormerBiasEncoder`` :441-509) and
``graphgps_tpu/models/networks.py:80-132`` ``FeatureEncoder``: the dataset
encoder embeds into ``d − dim_pe`` channels, the PE encoder appends its
``dim_pe`` (GraphormerBias adds its degree embeddings in place and takes no
width), and padded node slots are zeroed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import parse_times_func
from ..data.graph import GraphBatch
from ..ops.kernels.common import exact_dropout
from .common import MLP, LayerNorm, MaskedBatchNorm
from .gps_layer import StepSeeds, draw_seeds

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


class TypeDictNodeEncoder(nn.Module):
    """One embedding of the node type, column 0 of the integer features
    (ZINC: 28 types)."""

    def __init__(self, num_types: int, dim_emb: int):
        super().__init__()
        self.embedding = nn.Embedding(num_types, dim_emb)

    def forward(self, feats):
        return self.embedding(feats[:, 0].long())


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


def draw_signs(gen, K: int):
    """(K,) signs, +1 or -1 with equal chance, from the host generator (a
    training step's, where ``gen`` is its ``StepSeeds``)."""
    if gen is None:
        raise ValueError("training LapPE needs the sign generator")
    if isinstance(gen, StepSeeds):
        gen = gen.host_generator()
    return torch.randint(0, 2, (K,), generator=gen) * 2.0 - 1.0


class FreqEncoderLayer(nn.Module):
    """One post-norm ``nn.TransformerEncoderLayer`` over a node's frequency
    axis, as the JAX package writes it out (``encoders.py:298-315``): MHA
    with q, k, v projections (flax ``DenseGeneral``, here ``qkv``) whose
    logits at a padded frequency's key are −1e30 (a padded node has no real
    frequency; its softmax is then uniform, not NaN), the out-projection,
    residual and flax's LayerNorm (``norm1``); then relu FFN of ``ffn_dim``
    (``ffn1``, ``ffn2``), residual and LayerNorm (``norm2``). Dropout on four
    sites with flax ``nn.Dropout``'s exact rate (``exact_dropout``): the
    attention probabilities (site 0), the attention output (1), the FFN's
    hidden units (2) and its output (3)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"posenc_LapPE.dim_pe={dim} is not divisible by "
                             f"posenc_LapPE.n_heads={num_heads}")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, h, freq_mask, seed: int = 0, rate: float = 0.0):
        """h: (S, K, dim); freq_mask: (S, K) real frequencies."""
        S, K, dim = h.shape
        H = self.num_heads
        q, k, v = (t.reshape(S, K, H, dim // H)
                   for t in self.qkv(h).split(dim, dim=-1))
        logits = torch.einsum("skhd,slhd->shkl", q, k) / math.sqrt(dim // H)
        logits = torch.where(freq_mask[:, None, None, :], logits, -1e30)
        attn = exact_dropout(torch.softmax(logits, dim=-1), seed, 0, rate)
        o = torch.einsum("shkl,slhd->skhd", attn, v).reshape(S, K, dim)
        h = self.norm1(h + exact_dropout(self.out(o), seed, 1, rate))
        f = exact_dropout(torch.relu(self.ffn1(h)), seed, 2, rate)
        return self.norm2(h + exact_dropout(self.ffn2(f), seed, 3, rate))


class LapPENodeEncoder(nn.Module):
    """LapPE: per node the ``max_freqs`` (eigenvector entry, eigenvalue)
    pairs go through the frequency model, the NaN-padded frequencies are
    masked, the rest summed over the frequency axis, then ``post_layers``
    more Linears (``post``). The model is a DeepSet, ``layers`` Linears with
    relu (``pre``), or a Transformer: a Linear to ``dim_pe`` (``linear_a``)
    and ``layers`` ``FreqEncoderLayer``s (``transformer``) with ``n_heads``,
    an FFN of ``ffn_dim`` (torch's default 2048, which the reference keeps)
    and dropout ``dropout`` in training, its seeds one per layer from the
    host generator. In training the eigenvectors' signs are flipped at
    random, one sign per frequency, drawn from the host generator.
    ``raw_norm_type`` BatchNorm normalises the raw pairs per frequency over
    (real nodes × 2)."""

    def __init__(self, dim_pe: int, max_freqs: int, model: str = "DeepSet",
                 layers: int = 2, post_layers: int = 0,
                 raw_norm_type: str = "none", n_heads: int = 4,
                 ffn_dim: int = 2048, dropout: float = 0.1):
        super().__init__()
        if model not in ("DeepSet", "Transformer"):
            raise NotImplementedError(
                f"posenc_LapPE.model={model!r}: the port has the DeepSet and "
                "Transformer forms (ROADMAP Queue 1 item 16)")
        self.raw_norm = (MaskedBatchNorm(max_freqs)
                         if raw_norm_type.lower() == "batchnorm" else None)
        self.pre = self.linear_a = self.transformer = None
        if model == "Transformer":
            self.dropout = dropout
            self.linear_a = nn.Linear(2, dim_pe)
            self.transformer = nn.ModuleList(
                FreqEncoderLayer(dim_pe, n_heads, ffn_dim)
                for _ in range(layers))
        else:
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

    def frequencies(self, h, freq_mask, gen=None):
        """The frequency model over h (S, K, 2) → (S, K, dim_pe)."""
        if self.transformer is None:
            for lin in self.pre:
                h = torch.relu(lin(h))
            return h
        h = self.linear_a(h)
        rate = self.dropout if self.training else 0.0
        seeds = [0] * len(self.transformer)
        if rate > 0.0:
            seeds = draw_seeds(gen, len(self.transformer))
        for layer, seed in zip(self.transformer, seeds):
            h = layer(h, freq_mask, seed, rate)
        return h

    def forward(self, batch: GraphBatch, x,
                gen: Optional[torch.Generator] = None):
        dtype = (self.linear_a or self.pre[0]).weight.dtype
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
        h = self.frequencies(h, freq_mask, gen)
        pe = torch.where(freq_mask[..., None], h, 0.0).sum(dim=1)
        if self.post is not None:
            pe = self.post(pe)
        return torch.cat([x, pe], dim=-1) if x is not None else pe


class GraphormerBiasEncoder(nn.Module):
    """Graphormer's structural encodings (``encoders.py:441-509``): the
    additive per-head attention bias and the degree embeddings, and the
    graph token.

    - ``attn_bias``: (B, H, N, N) from the spatial (shortest-path distance)
      type's embedding (``spatial``, 22 = num_spatial_types + 2 rows) plus,
      with edge paths, the edge encoding along the shortest paths: hop k's
      edge type embedded (``edge_type``) and mixed by its own H×H matrix
      (``edge_dis``), summed over the D hops (all D: hops past the path read
      type 0, as in JAX) and divided by max(distance type, 1). Here the
      embedding is folded into the mixing first, a (D·T, H) table with
      ``T = num_edge_types``, and the sum over hops is one product of each
      pair's one-hot (hop, type) row with it: no (B, N, N, D, H) tensor is
      formed, and the table's gradient is a product too (a scatter of
      B·N²·D rows into the table, as ``embedding_bag``'s backward, took
      ~5.8 ms a training step at batch 256 on an H100). With the graph
      token the bias grows a row and a column of ``graph_token_bias`` at
      position 0: (B, H, N+1, N+1).
    - ``forward``: x plus the in- and out-degree embeddings (degrees clipped
      to their tables).
    - ``token_state``: the learned ``graph_token`` (d,) for each graph.
    """

    def __init__(self, dim: int, num_heads: int, num_spatial_types: int = 20,
                 num_in_degrees: int = 64, num_out_degrees: int = 64,
                 node_degrees_only: bool = False,
                 use_graph_token: bool = False, num_edge_types: int = 4,
                 edge_paths: bool = True):
        super().__init__()
        H = num_heads
        self.node_degrees_only = node_degrees_only
        self.edge_paths = edge_paths and not node_degrees_only
        self.num_edge_types = num_edge_types
        self.use_graph_token = use_graph_token
        self.num_in, self.num_out = num_in_degrees, num_out_degrees
        init = lambda *shape: nn.Parameter(  # noqa: E731
            torch.randn(*shape) * 0.02)
        if not node_degrees_only:
            self.spatial = init(num_spatial_types + 2, H)
            if self.edge_paths:
                self.edge_type = init(num_edge_types, H)
                self.edge_dis = init(num_spatial_types, H, H)
            if use_graph_token:
                self.graph_token_bias = init(H)
        self.in_degree = init(num_in_degrees, dim)
        self.out_degree = init(num_out_degrees, dim)
        if use_graph_token:
            self.graph_token = init(dim)

    def forward(self, batch: GraphBatch, x):
        in_deg = batch.pe["in_degrees"][:, 0].long().clamp(0, self.num_in - 1)
        out_deg = batch.pe["out_degrees"][:, 0].long().clamp(
            0, self.num_out - 1)
        x = x + F.embedding(in_deg, self.in_degree)
        return x + F.embedding(out_deg, self.out_degree)

    def attn_bias(self, batch: GraphBatch):
        """(B, H, N, N) or, with the graph token, (B, H, N+1, N+1); None
        with ``node_degrees_only``."""
        if self.node_degrees_only:
            return None
        spatial = batch.extras["spatial_types"].long()        # (B, N, N)
        bias = F.embedding(spatial, self.spatial)              # (B, N, N, H)
        if self.edge_paths:
            spt = batch.extras.get("shortest_path_types")
            if spt is None:
                raise ValueError(
                    "posenc_GraphormerBias.has_edge_attr: the batch holds no "
                    "shortest_path_types (a dataset without edge features)")
            B, N, _, D = spt.shape
            T, H = self.num_edge_types, self.spatial.shape[1]
            table = torch.einsum("th,dhk->dtk", self.edge_type, self.edge_dis)
            types = torch.arange(T, device=spt.device, dtype=spt.dtype)
            onehot = spt.clamp(max=T - 1)[..., None] == types  # (B,N,N,D,T)
            mixed = (onehot.reshape(-1, D * T).to(table.dtype)
                     @ table.reshape(D * T, H))
            denom = torch.clamp(spatial, min=1).to(mixed.dtype)
            bias = bias + mixed.reshape(B, N, N, H) / denom[..., None]
        bias = bias.permute(0, 3, 1, 2)
        if self.use_graph_token:
            B, H, N, _ = bias.shape
            tb = self.graph_token_bias[None, :, None, None]
            bias = torch.cat([tb.expand(B, H, 1, N + 1),
                              torch.cat([tb.expand(B, H, N, 1), bias], dim=3)],
                             dim=2)
        return bias

    def token_state(self, num_graphs: int):
        """(B, d) graph token states, or None without the token."""
        if not self.use_graph_token:
            return None
        return self.graph_token[None, :].expand(num_graphs, -1)


NODE_ENCODERS = ("Atom", "VOCNode", "LinearNode")
PE_ENCODERS = ("RWSE", "LapPE")
EDGE_ENCODERS = ("Bond", "VOCEdge", "LinearEdge")


class FeatureEncoder(nn.Module):
    """The dataset's node encoder with one appended encoding, and its edge
    encoder, from ``dataset.node_encoder_name`` (``<node>+<pe>``) and
    ``dataset.edge_encoder_name``: ``Atom+RWSE``/``Bond`` on the molecule
    recipes (modules ``atom``, ``rwse``, ``bond``), ``VOCNode+LapPE``/
    ``VOCEdge`` on the superpixels (``node_lin``, ``lap``, ``edge_lin``);
    an encoding's name alone (``LapPE`` on the transductive node recipes)
    projects the raw float features to ``dim_h - dim_pe`` with one Linear
    (``node_lin``, JAX ``networks.py:105-112``) before the encoding is
    appended; with ``edge_encoder`` off there is no edge encoder and e is
    None; ``TypeDictNode+GraphormerBias`` and no edge encoder on the
    Graphormer recipe (``type_dict``, ``graphormer``: the degree embeddings
    added in place; the network reads the attention bias and the graph
    token from ``graphormer``)."""

    def __init__(self, cfg, dim_h: int):
        super().__init__()
        ds = cfg.dataset
        node, _, pe = ds.node_encoder_name.partition("+")
        self.graphormer = None
        if pe == "GraphormerBias":
            self._init_graphormer(cfg, dim_h, node)
            return
        pe_only = node in PE_ENCODERS and not pe
        if pe_only:
            node, pe = None, node
        if not (ds.node_encoder and (pe_only or node in NODE_ENCODERS)
                and pe in PE_ENCODERS
                and (not ds.edge_encoder
                     or ds.edge_encoder_name in EDGE_ENCODERS)
                and not ds.node_encoder_bn and not ds.edge_encoder_bn
                and (pe != "RWSE" or cfg.posenc_RWSE.model == "Linear")):
            raise NotImplementedError(
                f"encoders {ds.node_encoder_name!r}/{ds.edge_encoder_name!r}: "
                f"the port has one of {NODE_ENCODERS} with one of "
                f"{PE_ENCODERS} (RWSE with a Linear model, LapPE as a "
                "DeepSet or a Transformer), or one of those encodings alone, "
                f"one of {EDGE_ENCODERS} or none, and no encoder BatchNorm "
                "(ROADMAP Queue 1 items 12 and 16)")
        p = cfg[f"posenc_{pe}"]
        if node == "Atom":
            self.atom = AtomEncoder(dim_h - p.dim_pe)
        else:
            if pe_only and not cfg.share.dim_in:
                raise ValueError("the raw features' width cfg.share.dim_in "
                                 "is unset (driver.infer_dims sets it)")
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
                raw_norm_type=p.raw_norm_type, n_heads=p.n_heads)
        self.edge_name = None
        if ds.edge_encoder and ds.edge_encoder_name == "Bond":
            self.bond = BondEncoder(dim_h)
            self.edge_name = "bond"
        elif ds.edge_encoder:
            self.edge_lin = LinearEncoder(VOC_EDGE_DIM, dim_h)
            self.edge_name = "edge_lin"
        self.node_name = "atom" if node == "Atom" else "node_lin"
        self.pe_name = "rwse" if pe == "RWSE" else "lap"

    def _init_graphormer(self, cfg, dim_h: int, node: str) -> None:
        ds = cfg.dataset
        if not (ds.node_encoder and node == "TypeDictNode"
                and not ds.edge_encoder and not ds.node_encoder_bn):
            raise NotImplementedError(
                f"encoders {ds.node_encoder_name!r} with edge_encoder="
                f"{ds.edge_encoder}: the port has TypeDictNode+GraphormerBias "
                "with no edge encoder and no encoder BatchNorm (ROADMAP "
                "Queue 1 items 12 and 16)")
        p = cfg.posenc_GraphormerBias
        self.type_dict = TypeDictNodeEncoder(ds.node_encoder_num_types, dim_h)
        self.graphormer = GraphormerBiasEncoder(
            dim_h, cfg.graphormer.num_heads, p.num_spatial_types,
            p.num_in_degrees, p.num_out_degrees, p.node_degrees_only,
            # the token belongs to the Graphormer stack (networks.py:64-75)
            cfg.graphormer.use_graph_token and cfg.model.type == "Graphormer",
            max(2, ds.edge_encoder_num_types), bool(p.has_edge_attr))

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """``gen`` draws LapPE's training sign flip. Returns (x, e); e is
        None without an edge encoder."""
        if self.graphormer is not None:
            x = self.graphormer(batch, self.type_dict(batch.node_feat))
            return torch.where(batch.node_mask[:, None], x, 0.0), None
        x = getattr(self, self.node_name)(batch.node_feat)
        x = getattr(self, self.pe_name)(batch, x, gen)
        e = None
        if self.edge_name is not None:
            e = getattr(self, self.edge_name)(batch.edge_feat)
        x = torch.where(batch.node_mask[:, None], x, 0.0)
        return x, e
