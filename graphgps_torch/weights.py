"""Carry a JAX GPSModel's (CustomGatedGCN or GCN layers), SANTransformer's
or GraphormerNet's flax variables over to the port's state dict.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of the variables). The same mapping names a
params-shaped tree of gradients (``batch_stats=None``) by the port's
parameter names, so tests compare gradients, updated parameters and updated
running statistics key by key. A flax ``Dense`` kernel
is (in, out): the GPS layers keep it so, since their kernels take that
layout, and the ``nn.Linear`` weights of the encoders (RWSE, LapPE, the
Linear node and edge encoders) and of the heads (san_graph, the node head's
MLP) take it transposed (out, in); an ``Embed`` table stays as it is; a ``MaskedBatchNorm``'s ``scale``/``bias`` and its
running ``mean``/``var`` (biased) become ``weight``/``bias`` and
``running_mean``/``running_var``. The layer stack may be unrolled
(``GPSLayer_<i>``, or ``CheckpointGPSLayer_<i>`` under remat) or stacked on
axis 0 under ``nn.scan`` (``...GPSScanBody_0/GPSLayer_0``). A GraphormerNet
(``GraphormerLayer_<i>``, ``GraphormerGraphHead_0``) maps as
``graphormer_layer_state_dict`` says, a SANTransformer (``SANLayer_<i>``)
as ``san_layer_state_dict`` says; a flax ``LayerNorm``'s ``scale`` is the
port's ``weight``. A ``DenseGeneral`` kernel (in, H, Dh) is flattened to
(in, H·Dh).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .models.gps_layer import merged_width

_UNROLLED = re.compile(r"^(?:Checkpoint)?GPSLayer_(\d+)$")
_GRAPHORMER = re.compile(r"^GraphormerLayer_(\d+)$")
_SAN = re.compile(r"^SANLayer_(\d+)$")


def _linear(out: dict, prefix: str, dense: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(dense["kernel"]).T
    out[f"{prefix}.bias"] = np.asarray(dense["bias"])


def _bn(out: dict, prefix: str, params: dict, stats) -> None:
    out[f"{prefix}.weight"] = params["scale"]
    out[f"{prefix}.bias"] = params["bias"]
    if stats is not None:
        out[f"{prefix}.running_mean"] = stats["mean"]
        out[f"{prefix}.running_var"] = stats["var"]


def _norm(out: dict, prefix: str, params: dict, stats, name: str):
    _bn(out, prefix, params[name]["MaskedBatchNorm_0"],
        None if stats is None else stats[name]["MaskedBatchNorm_0"])


def gps_layer_state_dict(p: dict, s, prefix: str = "") -> dict:
    """One GPSLayer's flax params/batch_stats → the port's ``GPSLayer``
    state dict (numpy values), keys prefixed with ``prefix``. The port keeps
    flax's (in, out) layout here; the GatedGCN's Dense_0..4 are A..E. A
    layer at a width that is a multiple of 128 holds the front's joint
    weight ``[A|D|E|B|Wq|Wk|Wv]`` on either path (as one flax tree serves
    every path in JAX); one at another width holds ``[A|D|E|B]`` in its
    local layer and ``[Wq|Wk|Wv]`` beside it. The flax
    names are the same on both paths, in training and in evaluation
    (``Norm_0`` the attention norm, ``Norm_1`` the final norm). ``s=None``
    maps the parameters only."""
    if "GCNLayer_0" in p:
        return gcn_layer_state_dict(p, s, prefix)
    out: dict = {}
    g = p["GatedGCNLayer_0"]
    gs = None if s is None else s["GatedGCNLayer_0"]
    dense = {lin: g[f"Dense_{i}"] for i, lin in enumerate("ABCDE")}
    d = p["qkv_kernel"].shape[0]
    node_w = [np.asarray(dense[k]["kernel"]) for k in "ADEB"]
    node_b = [np.asarray(dense[k]["bias"]) for k in "ADEB"]
    qkv_w = np.asarray(p["qkv_kernel"]).reshape(d, 3 * d)
    qkv_b = np.asarray(p["qkv_bias"]).reshape(3 * d)
    if merged_width(d):
        out[f"{prefix}.w_front"] = np.concatenate(node_w + [qkv_w], axis=1)
        out[f"{prefix}.b_front"] = np.concatenate(node_b + [qkv_b])
    else:
        out[f"{prefix}.local.w_node"] = np.concatenate(node_w, axis=1)
        out[f"{prefix}.local.b_node"] = np.concatenate(node_b)
        out[f"{prefix}.w_qkv"] = qkv_w
        out[f"{prefix}.b_qkv"] = qkv_b
    out[f"{prefix}.local.w_c"] = dense["C"]["kernel"]
    out[f"{prefix}.local.b_c"] = dense["C"]["bias"]
    _norm(out, f"{prefix}.local.norm_x", g, gs, "Norm_0")
    _norm(out, f"{prefix}.local.norm_e", g, gs, "Norm_1")
    out[f"{prefix}.w_out"] = p["out_kernel"]
    out[f"{prefix}.b_out"] = p["out_bias"]
    _norm(out, f"{prefix}.norm_attn", p, s, "Norm_0")
    for i in (1, 2):
        out[f"{prefix}.w_ffn{i}"] = p[f"Dense_{i - 1}"]["kernel"]
        out[f"{prefix}.b_ffn{i}"] = p[f"Dense_{i - 1}"]["bias"]
    _norm(out, f"{prefix}.norm_out", p, s, "Norm_1")
    return {k.lstrip("."): v for k, v in out.items()}


def gcn_layer_state_dict(p: dict, s, prefix: str = "") -> dict:
    """One GCN+Transformer GPSLayer's flax params/batch_stats → the port's
    ``GPSLayer`` state dict: ``GCNLayer_0/Dense_0`` → ``local.w``/
    ``local.b``, ``qkv_*`` → ``w_qkv``/``b_qkv``, ``out_*``, the FFN's
    ``Dense_0``/``Dense_1``, and with BatchNorm ``Norm_0``/``Norm_1``/
    ``Norm_2`` → ``norm_local``/``norm_attn``/``norm_out`` (without it the
    norms hold no variables)."""
    out: dict = {}
    d = p["qkv_kernel"].shape[0]
    out[f"{prefix}.local.w"] = p["GCNLayer_0"]["Dense_0"]["kernel"]
    out[f"{prefix}.local.b"] = p["GCNLayer_0"]["Dense_0"]["bias"]
    out[f"{prefix}.w_qkv"] = np.asarray(p["qkv_kernel"]).reshape(d, 3 * d)
    out[f"{prefix}.b_qkv"] = np.asarray(p["qkv_bias"]).reshape(3 * d)
    out[f"{prefix}.w_out"] = p["out_kernel"]
    out[f"{prefix}.b_out"] = p["out_bias"]
    for i in (1, 2):
        out[f"{prefix}.w_ffn{i}"] = p[f"Dense_{i - 1}"]["kernel"]
        out[f"{prefix}.b_ffn{i}"] = p[f"Dense_{i - 1}"]["bias"]
    for i, name in enumerate(("norm_local", "norm_attn", "norm_out")):
        if f"Norm_{i}" in p:
            _norm(out, f"{prefix}.{name}", p, s, f"Norm_{i}")
    return {k.lstrip("."): v for k, v in out.items()}


def graphormer_layer_state_dict(p: dict, prefix: str = "") -> dict:
    """One GraphormerLayer's flax params → the port's ``GraphormerLayer``
    state dict (numpy values), keys prefixed with ``prefix``: ``LayerNorm_0``
    → ``ln_attn``, ``Dense_0..2`` (q, k, v) side by side → ``w_qkv``/
    ``b_qkv``, ``Dense_3`` → ``w_out``/``b_out``, ``LayerNorm_1`` →
    ``ln_ffn``, ``Dense_4``/``Dense_5`` → ``w_ffn1``.. ``b_ffn2``, in flax's
    (in, out) layout."""
    out: dict = {}
    for name, ln in (("ln_attn", "LayerNorm_0"), ("ln_ffn", "LayerNorm_1")):
        out[f"{prefix}.{name}.weight"] = p[ln]["scale"]
        out[f"{prefix}.{name}.bias"] = p[ln]["bias"]
    out[f"{prefix}.w_qkv"] = np.concatenate(
        [np.asarray(p[f"Dense_{i}"]["kernel"]) for i in range(3)], axis=1)
    out[f"{prefix}.b_qkv"] = np.concatenate(
        [np.asarray(p[f"Dense_{i}"]["bias"]) for i in range(3)])
    for name, dense in (("out", 3), ("ffn1", 4), ("ffn2", 5)):
        out[f"{prefix}.w_{name}"] = p[f"Dense_{dense}"]["kernel"]
        out[f"{prefix}.b_{name}"] = p[f"Dense_{dense}"]["bias"]
    return {k.lstrip("."): v for k, v in out.items()}


def _flat(kernel) -> np.ndarray:
    """A ``DenseGeneral`` kernel (in, H, Dh) or bias (H, Dh) with its heads
    side by side: (in, H·Dh) or (H·Dh,)."""
    k = np.asarray(kernel)
    return k.reshape(k.shape[0], -1) if k.ndim == 3 else k.reshape(-1)


def san_layer_state_dict(p: dict, s, prefix: str = "") -> dict:
    """One SANLayer's flax params/batch_stats → the port's ``SANLayer``
    state dict (numpy values), keys prefixed with ``prefix``:
    ``SANAttention_0``'s Q, K, V, E, Q2, K2, E2 → ``attn.w_q``.. (flattened,
    no bias) and ``fake_edge_emb``; ``Dense_0..2`` → ``w_o``/``b_o``,
    ``w_ffn1``.., ``w_ffn2``..; ``Norm_0``/``Norm_1`` → ``norm1``/``norm2``
    (absent without BatchNorm). The kernel route and the plain route make the
    same names. ``s=None`` maps the parameters only."""
    out: dict = {}
    a = p["SANAttention_0"]
    for name in ("Q", "K", "V", "E", "Q2", "K2", "E2"):
        if name in a:
            out[f"{prefix}.attn.w_{name.lower()}"] = _flat(a[name]["kernel"])
    if "fake_edge_emb" in a:
        out[f"{prefix}.attn.fake_edge_emb"] = a["fake_edge_emb"]
    for name, dense in (("o", 0), ("ffn1", 1), ("ffn2", 2)):
        out[f"{prefix}.w_{name}"] = p[f"Dense_{dense}"]["kernel"]
        out[f"{prefix}.b_{name}"] = p[f"Dense_{dense}"]["bias"]
    for i in (0, 1):
        if f"Norm_{i}" in p:
            _norm(out, f"{prefix}.norm{i + 1}", p, s, f"Norm_{i}")
    return {k.lstrip("."): v for k, v in out.items()}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _layer_trees(params: dict, stats):
    """[(params, batch_stats or None)] per layer, in order."""
    scan = [k for k in params if k.endswith("GPSScanBody_0")]
    if scan:
        p = params[scan[0]]["GPSLayer_0"]
        s = None if stats is None else stats[scan[0]]["GPSLayer_0"]
        n = np.asarray(p["out_bias"]).shape[0]
        return [(_index(p, i), None if s is None else _index(s, i))
                for i in range(n)]
    found = sorted((int(m.group(1)), k) for k in params
                   if (m := _UNROLLED.match(k)))
    # a layer without norms holds no batch_stats
    return [(params[k], None if stats is None else stats.get(k, {}))
            for _, k in found]


def state_dict_from_flax(params: dict,
                         batch_stats=None) -> Dict[str, torch.Tensor]:
    """The port's state dict from flax ``params`` and ``batch_stats``; with
    ``batch_stats=None`` the parameters only (a gradient tree, say)."""
    out: dict = {}
    _encoder_state_dict(out, params["FeatureEncoder_0"],
                        None if batch_stats is None
                        else batch_stats.get("FeatureEncoder_0", {}))
    graphormer = sorted((int(m.group(1)), k) for k in params
                        if (m := _GRAPHORMER.match(k)))
    for i, k in graphormer:
        out.update(graphormer_layer_state_dict(params[k], f"layers.{i}"))
    san = sorted((int(m.group(1)), k) for k in params
                 if (m := _SAN.match(k)))
    for i, k in san:
        out.update(san_layer_state_dict(
            params[k], None if batch_stats is None else batch_stats.get(k),
            f"layers.{i}"))
    for i, (p, s) in enumerate(_layer_trees(params, batch_stats)):
        out.update(gps_layer_state_dict(p, s, f"layers.{i}"))
    if "GraphormerGraphHead_0" in params:
        head = params["GraphormerGraphHead_0"]
        out["head.norm.weight"] = head["LayerNorm_0"]["scale"]
        out["head.norm.bias"] = head["LayerNorm_0"]["bias"]
        _linear(out, "head.out", head["Dense_0"])
    elif "SANGraphHead_0" in params:
        head = params["SANGraphHead_0"]
        n = len(head)
        for i in range(n - 1):
            _linear(out, f"head.hidden.{i}", head[f"Dense_{i}"])
        _linear(out, "head.out", head[f"Dense_{n - 1}"])
    else:
        _dense_list(out, "head.mlp.layers",
                    params["InductiveNodeHead_0"]["MLP_0"])
    return to_torch(out)


def _dense_list(out: dict, prefix: str, tree: dict, first: int = 0,
                count: Optional[int] = None) -> None:
    """``tree``'s ``Dense_<first>``.. (``count`` of them, by default all
    that follow) → ``<prefix>.<i>`` Linears, i from 0."""
    n = count if count is not None else sum(
        k.startswith("Dense_") for k in tree) - first
    for i in range(n):
        _linear(out, f"{prefix}.{i}", tree[f"Dense_{first + i}"])


def _encoder_state_dict(out: dict, fe: dict, fs) -> None:
    """The FeatureEncoder's flax trees: embedding tables (Atom, Bond) or one
    Dense (VOCNode/LinearNode, VOCEdge/LinearEdge), and RWSE or LapPE (as a
    DeepSet or a Transformer)."""
    def stats(name):
        return None if fs is None else fs[name]["MaskedBatchNorm_0"]

    for enc, name in (("atom", "AtomEncoder_0"), ("bond", "BondEncoder_0")):
        for k, v in fe.get(name, {}).items():
            i = int(k.split("_")[1])
            out[f"encoder.{enc}.embeddings.{i}.weight"] = v["embedding"]
    if "TypeDictNodeEncoder_0" in fe:
        out["encoder.type_dict.embedding.weight"] = \
            fe["TypeDictNodeEncoder_0"]["Embed_0"]["embedding"]
    if "GraphormerBiasEncoder_0" in fe:
        _graphormer_bias_state_dict(out, fe["GraphormerBiasEncoder_0"])
    if "Dense_0" in fe:
        # an encoding's name alone: the raw features' projection
        _linear(out, "encoder.node_lin.proj", fe["Dense_0"])
    for enc, names in (("node_lin", ("VOCNodeEncoder_0", "LinearNodeEncoder_0")),
                       ("edge_lin", ("LinearEdgeEncoder_0",))):
        for name in names:
            if name in fe:
                _linear(out, f"encoder.{enc}.proj", fe[name]["Dense_0"])
    if "RWSENodeEncoder_0" in fe:
        rw = fe["RWSENodeEncoder_0"]
        if "MaskedBatchNorm_0" in rw:
            _bn(out, "encoder.rwse.raw_norm", rw["MaskedBatchNorm_0"],
                stats("RWSENodeEncoder_0"))
        _linear(out, "encoder.rwse.proj", rw["Dense_0"])
    if "LapPENodeEncoder_0" in fe:
        lap = fe["LapPENodeEncoder_0"]
        if "MaskedBatchNorm_0" in lap:
            _bn(out, "encoder.lap.raw_norm", lap["MaskedBatchNorm_0"],
                stats("LapPENodeEncoder_0"))
        if "DenseGeneral_0" in lap:
            _lappe_transformer_state_dict(out, lap)
        else:
            _lappe_deepset_state_dict(out, lap)


def _lappe_deepset_state_dict(out: dict, lap: dict) -> None:
    """LapPE's DeepSet form: its Denses, then one post Dense or the post
    ``MLP_0``."""
    n = sum(k.startswith("Dense_") for k in lap)
    if "MLP_0" in lap:
        _dense_list(out, "encoder.lap.post.layers", lap["MLP_0"])
    elif n > 1 and _square(lap[f"Dense_{n - 1}"]):
        # dim_pe → dim_pe: the one post layer (the DeepSet's own last Dense
        # narrows 2·dim_pe to dim_pe)
        _dense_list(out, "encoder.lap.post.layers", lap, n - 1, 1)
        n -= 1
    _dense_list(out, "encoder.lap.pre", lap, 0, n)


def _lappe_transformer_state_dict(out: dict, lap: dict) -> None:
    """LapPE's Transformer form. flax numbers in call order: ``Dense_0``
    (``linear_a``); per layer l ``DenseGeneral_{3l..3l+2}`` (q, k, v, with
    biases) → ``qkv``, ``Dense_{1+3l}`` → ``out``, ``LayerNorm_{2l}`` →
    ``norm1``, ``Dense_{2+3l}``/``Dense_{3+3l}`` → ``ffn1``/``ffn2``,
    ``LayerNorm_{2l+1}`` → ``norm2``; then the post layers (``Dense``s after
    the stack, or ``MLP_0``)."""
    layers = sum(k.startswith("DenseGeneral_") for k in lap) // 3
    _linear(out, "encoder.lap.linear_a", lap["Dense_0"])
    for li in range(layers):
        pre = f"encoder.lap.transformer.{li}"
        qkv = [lap[f"DenseGeneral_{3 * li + j}"] for j in range(3)]
        out[f"{pre}.qkv.weight"] = np.concatenate(
            [_flat(g["kernel"]) for g in qkv], axis=1).T
        out[f"{pre}.qkv.bias"] = np.concatenate([_flat(g["bias"]) for g in qkv])
        for name, dense in (("out", 1), ("ffn1", 2), ("ffn2", 3)):
            _linear(out, f"{pre}.{name}", lap[f"Dense_{dense + 3 * li}"])
        for j in (0, 1):
            ln = lap[f"LayerNorm_{2 * li + j}"]
            out[f"{pre}.norm{j + 1}.weight"] = ln["scale"]
            out[f"{pre}.norm{j + 1}.bias"] = ln["bias"]
    if "MLP_0" in lap:
        _dense_list(out, "encoder.lap.post.layers", lap["MLP_0"])
    else:
        _dense_list(out, "encoder.lap.post.layers", lap, 1 + 3 * layers)


def _graphormer_bias_state_dict(out: dict, gb: dict) -> None:
    """The GraphormerBias encoder's tables. flax numbers its ``Embed``s in
    call order: the spatial table and, with edge paths, the edge-type table
    come before the in- and out-degree tables (degrees only: just those
    two)."""
    tables = [gb[f"Embed_{i}"]["embedding"]
              for i in range(sum(k.startswith("Embed_") for k in gb))]
    names = ["in_degree", "out_degree"]
    if "edge_dis_encoder" in gb:
        names = ["spatial", "edge_type"] + names
        out["encoder.graphormer.edge_dis"] = gb["edge_dis_encoder"]
    elif len(tables) == 3:
        names = ["spatial"] + names
    for name, t in zip(names, tables):
        out[f"encoder.graphormer.{name}"] = t
    for name in ("graph_token", "graph_token_bias"):
        if name in gb:
            out[f"encoder.graphormer.{name}"] = gb[name]


def _square(dense: dict) -> bool:
    a, b = np.asarray(dense["kernel"]).shape
    return a == b


def to_torch(sd: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def load_flax(model: torch.nn.Module, params: dict, batch_stats: dict) -> None:
    """Load the flax variables into ``model``. Every flax leaf must land; the
    only port tensors allowed to stay as initialized are embedding tables for
    feature columns the JAX model never saw (it creates one per column of the
    data)."""
    sd = state_dict_from_flax(params, batch_stats)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    stray = [k for k in missing
             if not re.match(r"encoder\.(atom|bond)\.embeddings\.\d+\.weight$", k)]
    if unexpected or stray:
        raise KeyError(f"flax → torch mismatch: unexpected {unexpected}, "
                       f"missing {stray}")
