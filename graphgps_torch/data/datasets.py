"""Dataset loading for the port's paths: PCQM4Mv2, the OGB molecule sets
(``ogbg-mol*``), ZINC, the VOC superpixels and the transductive node sets
(Actor, WebKB, WikipediaNetwork), and the synthetic families they fall back
to.

Counterparts: ``graphgps_tpu/data/datasets/synthetic.py`` (``zinc_like`` and
``voc_like``, the same generators and the same random streams, so both
packages see the same graphs for one seed), ``data/datasets/real.py`` (the
PCQM4Mv2, ``ogbg-*``, ``PyG-ZINC``, ``PyG-VOCSuperpixels`` and transductive
→ synthetic fallbacks, :73-84, :87-96, :106-112, :189-209, :225-240 and
:277-330) and
``data/datasets/base.py``
(``DatasetSplits``, ``load_dataset`` with the PE precompute).
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import List

import numpy as np

from ..pe.host import compute_posenc
from .graph import Graph

log = logging.getLogger("graphgps_torch")

# the transductive node formats: one graph, per-split node masks
TRANSDUCTIVE_FORMATS = ("PyG-Actor", "PyG-WebKB", "PyG-WikipediaNetwork")


@dataclasses.dataclass
class DatasetSplits:
    train: List[Graph]
    val: List[Graph]
    test: List[Graph]

    @property
    def all_graphs(self) -> List[Graph]:
        return self.train + self.val + self.test


def _random_molecule(rng: np.random.Generator, n_min: int, n_max: int,
                     num_node_types: int, num_edge_types: int) -> Graph:
    n = int(rng.integers(n_min, n_max + 1))
    # random spanning tree + a few extra cycle edges — molecule-like sparsity
    senders, receivers = [], []
    for v in range(1, n):
        u = int(rng.integers(0, v))
        senders += [u, v]
        receivers += [v, u]
    n_extra = int(rng.integers(0, max(1, n // 8) + 1))
    for _ in range(n_extra):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            senders += [int(u), int(v)]
            receivers += [int(v), int(u)]
    ei = np.stack([np.array(senders, dtype=np.int64),
                   np.array(receivers, dtype=np.int64)])
    x = rng.integers(0, num_node_types, size=(n, 1)).astype(np.int64)
    e = rng.integers(0, num_edge_types, size=(ei.shape[1], 1)).astype(np.int64)
    return Graph(node_feat=x, edge_index=ei, edge_feat=e)


def _graph_label(g: Graph, num_node_types: int, w: np.ndarray) -> float:
    """Smooth structure+feature-dependent scalar target."""
    n = g.num_nodes
    deg = np.zeros(n)
    np.add.at(deg, g.edge_index[1], 1)
    type_hist = np.bincount(g.node_feat[:, 0], minlength=num_node_types) / max(n, 1)
    feats = np.concatenate([[n / 40.0, g.num_edges / (2.0 * max(n, 1)),
                             deg.mean() / 4.0, deg.std() / 2.0], type_hist])
    return float(np.tanh(feats @ w[:feats.shape[0]]) * 2.0)


def zinc_like(cfg) -> DatasetSplits:
    """Synthetic molecules (ZINC-like statistics) with graph-level targets:
    regression scalars, or for a classification task one integer class per
    graph (``max(2, synth_num_tasks)`` classes)."""
    d = cfg.dataset
    if d.task_type not in ("regression", "classification",
                           "classification_binary"):
        raise NotImplementedError(
            f"dataset.task_type={d.task_type!r}: the port supports graph "
            "regression and single-label classification (ROADMAP Queue 1 "
            "item 17)")
    rng = np.random.default_rng(d.synth_seed)
    n_types, e_types = d.node_encoder_num_types, d.edge_encoder_num_types
    w = rng.normal(size=(4 + n_types,))
    graphs = []
    for _ in range(d.synth_num_graphs):
        g = _random_molecule(rng, d.synth_min_nodes, d.synth_max_nodes,
                             n_types, e_types)
        if d.task_type == "regression":
            tasks = max(1, d.synth_num_tasks)
            y = np.array([_graph_label(g, n_types, np.roll(w, t))
                          for t in range(tasks)], dtype=np.float32)
            g.y = y if tasks > 1 else y[:1]
        else:
            score = _graph_label(g, n_types, w)
            n_classes = max(2, d.synth_num_tasks)
            g.y = np.array([int(abs(score * 7)) % n_classes], dtype=np.int64)
        graphs.append(g)
    return _split(graphs, d.split if len(d.split) == 3 else (0.8, 0.1, 0.1))


def _split(graphs: List[Graph], frac=(0.8, 0.1, 0.1)) -> DatasetSplits:
    n = len(graphs)
    a = int(n * frac[0])
    b = a + int(n * frac[1])
    return DatasetSplits(train=graphs[:a], val=graphs[a:b], test=graphs[b:])


def voc_like(cfg) -> DatasetSplits:
    """Node-classification graphs shaped like PascalVOC-SP: a ring of
    ``synth_min_nodes``..``synth_max_nodes`` nodes with float node features
    (n, 14), float edge features (E, 2) and one integer class per node
    (``max(2, synth_num_tasks)`` classes)."""
    d = cfg.dataset
    rng = np.random.default_rng(d.synth_seed)
    num_classes = max(2, d.synth_num_tasks)
    graphs = []
    for _ in range(d.synth_num_graphs):
        n = int(rng.integers(d.synth_min_nodes, d.synth_max_nodes + 1))
        x = rng.normal(size=(n, 14)).astype(np.float32)
        s = np.arange(n)
        r = (s + 1) % n
        ei = np.stack([np.concatenate([s, r]), np.concatenate([r, s])])
        e = rng.normal(size=(ei.shape[1], 2)).astype(np.float32)
        y = (np.abs(x @ rng.normal(size=(14,))) * 3).astype(np.int64) % num_classes
        graphs.append(Graph(node_feat=x, edge_index=ei, edge_feat=e, y=y))
    return _split(graphs)


def transductive_like(cfg) -> DatasetSplits:
    """One random graph shared by three splits, as the JAX loader's
    transductive fallback draws it (``real.py:305-324``, the same draws in
    the same order): n = max(64, ``synth_num_graphs``) nodes, 4n random
    pairs without self-pairs in both directions (repeats stay, as
    multi-edges), float features (n, 16), five classes, and a random 60/20/20
    node split as ``split_mask`` extras of three views of the graph."""
    rng = np.random.default_rng(cfg.dataset.synth_seed)
    n = max(64, cfg.dataset.synth_num_graphs)
    s = rng.integers(0, n, 4 * n)
    r = rng.integers(0, n, 4 * n)
    keep = s != r
    ei = np.stack([np.concatenate([s[keep], r[keep]]),
                   np.concatenate([r[keep], s[keep]])])
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = (np.abs(x @ rng.normal(size=(16,))) * 2).astype(np.int64) % 5
    g = Graph(node_feat=x, edge_index=ei, y=y)
    order = rng.permutation(n)
    cuts = (0, int(0.6 * n), int(0.8 * n), n)
    views = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        mask = np.zeros(n, bool)
        mask[order[a:b]] = True
        views.append([g.view_with_extras(split_mask=mask)])
    return DatasetSplits(*views)


def _transductive(cfg) -> DatasetSplits:
    """``PyG-Actor``, ``PyG-WebKB`` and ``PyG-WikipediaNetwork``
    (``real.py:289`` ``load_transductive_node``): geom-gcn raw files under
    ``<dir>/<family>/<name>`` (``film`` for Actor) raise, since reading them
    is not ported; the stand-in otherwise."""
    fam = cfg.dataset.format.replace("PyG-", "")
    name = cfg.dataset.name
    stem = "film" if name.lower() in ("actor", "film", "none") else name
    present = any(
        os.path.exists(os.path.join(root, sub, "out1_graph_edges.txt"))
        for root in (os.path.join(cfg.dataset.dir, fam), cfg.dataset.dir)
        for sub in (os.path.join(stem, "raw"), os.path.join(name, "raw"),
                    stem))
    return _fallback(cfg, os.path.join(cfg.dataset.dir, fam), present,
                     "transductive")


def _fallback(cfg, root: str, present: bool,
              kind: str = "zinc-like") -> DatasetSplits:
    """The real files are not in the repository, so the run takes the same
    synthetic stand-in (``kind``) as the JAX loader's fallback; real files
    under ``root`` raise, since reading them is not ported."""
    if present:
        raise NotImplementedError(
            f"real dataset files found under {root}: reading them is not "
            "ported yet (ROADMAP Queue 1 item 19)")
    if not cfg.dataset.get("synthetic_fallback", True):
        raise FileNotFoundError(
            f"dataset {cfg.dataset.format}/{cfg.dataset.name} not found under "
            f"{cfg.dataset.dir} and synthetic_fallback is disabled")
    log.warning("dataset %s/%s not cached under %s — substituting synthetic "
                "%s", cfg.dataset.format, cfg.dataset.name, cfg.dataset.dir,
                kind)
    return {"voc-like": voc_like, "transductive": transductive_like}.get(
        kind, zinc_like)(cfg)


def _pcqm4mv2(cfg) -> DatasetSplits:
    root = os.path.join(cfg.dataset.dir, "pcqm4m-v2")
    return _fallback(cfg, root, (
        os.path.exists(os.path.join(root, "processed.npz"))
        or os.path.exists(os.path.join(root, "raw", "data.csv.gz"))))


def _ogb_graph(cfg, name: str) -> DatasetSplits:
    """``ogbg-mol*`` (``real.py:106`` ``_load_ogb_graph``)."""
    root = os.path.join(cfg.dataset.dir, name.replace("-", "_"))
    return _fallback(cfg, root, os.path.isdir(os.path.join(root, "raw")))


def _zinc(cfg) -> DatasetSplits:
    """``PyG-ZINC`` (``real.py:87`` ``load_zinc``): the raw pickles and the
    legacy caches all sit under ``ZINC/``."""
    root = os.path.join(cfg.dataset.dir, "ZINC")
    return _fallback(cfg, root, os.path.isdir(root))


def _voc_superpixels(cfg) -> DatasetSplits:
    """``PyG-VOCSuperpixels`` (``real.py:225`` ``load_superpixels``): the
    upstream pickles sit under ``VOCSuperpixels/slic_compactness_<c>/``."""
    root = os.path.join(cfg.dataset.dir, "VOCSuperpixels")
    return _fallback(cfg, root, os.path.isdir(root), "voc-like")


def load_dataset(cfg) -> DatasetSplits:
    fmt, name = cfg.dataset.format, cfg.dataset.name
    if fmt.startswith("synthetic"):
        if fmt == "synthetic-voc-like":
            splits = voc_like(cfg)
        elif fmt in ("synthetic", "synthetic-zinc-like"):
            splits = zinc_like(cfg)
        else:
            raise NotImplementedError(
                f"dataset.format={fmt!r} is not ported (ROADMAP Queue 1 "
                "item 14)")
    elif fmt == "PyG-VOCSuperpixels":
        splits = _voc_superpixels(cfg)
    elif fmt == "PyG-ZINC":
        splits = _zinc(cfg)
    elif ((fmt == "OGB" and name.startswith("PCQM4Mv2-"))
            or fmt in ("OGB-LSC", "PCQM4Mv2")):
        splits = _pcqm4mv2(cfg)
    elif fmt == "OGB" and name.replace("_", "-").startswith("ogbg-mol"):
        splits = _ogb_graph(cfg, name.replace("_", "-"))
    elif fmt in TRANSDUCTIVE_FORMATS:
        splits = _transductive(cfg)
    else:
        raise NotImplementedError(
            f"dataset {fmt}/{name} is not ported yet (ROADMAP Queue 1 "
            "items 12-19)")
    if cfg.dataset.split_mode != "standard":
        raise NotImplementedError(
            f"dataset.split_mode={cfg.dataset.split_mode!r} is not ported "
            "(ROADMAP Queue 1 item 19)")
    compute_posenc(splits.all_graphs, cfg)
    return splits
