"""Experiment driver: config → loaders → model → train or evaluate, looped
over seeds (counterpart of ``graphgps_tpu/driver.py:31-289`` ``run_single``).

The entry point runs on the GPU: ``--device`` defaults to ``cuda`` and a
machine without one raises; ``--device cpu`` runs the kernels' plain
versions (the tests use it).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import (CfgNode, dump_cfg, load_cfg, new_cfg, update_from_list,
                     validate_cfg)
from .data.datasets import DatasetSplits, load_dataset
from .data.loader import DeviceLoader, choose_caps, round_up
from .models.networks import build_model
from .train.loop import TRAIN_MODES

log = logging.getLogger("graphgps_torch")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="graphgps_torch experiment driver")
    p.add_argument("--cfg", dest="cfg_file", type=str, required=True)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                   help="dotted config overrides: key value [key value ...]")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: graphgps_torch runs on the GPU "
                "(pass --device cpu to run the plain PyTorch versions)")
    elif dev.type != "cpu":
        raise ValueError(f"--device {name!r}: use cuda or cpu")
    return dev


def set_out_dir(cfg: CfgNode, cfg_file: str) -> None:
    run_name = os.path.splitext(os.path.basename(cfg_file))[0]
    if cfg.name_tag:
        run_name += f"-{cfg.name_tag}"
    cfg.out_dir = os.path.join(cfg.out_dir, run_name)


def run_loop_settings(cfg: CfgNode, repeat: int) -> Tuple[List[int], List[int], List[int]]:
    """(run_ids, seeds, split_indices): multi-seed XOR multi-split."""
    if len(cfg.run_multiple_splits) == 0:
        seeds = [cfg.seed + i for i in range(repeat)]
        return seeds, seeds, [cfg.dataset.split_index] * repeat
    if repeat != 1:
        raise NotImplementedError(
            "run_multiple_splits and repeat>1 are mutually exclusive")
    split_indices = list(cfg.run_multiple_splits)
    return split_indices, [cfg.seed] * len(split_indices), split_indices


def infer_dims(cfg: CfgNode, splits: DatasetSplits) -> int:
    """Output width from the targets (``graphgps_tpu/driver.py:66-90``): the
    number of regression targets or of labels (a multilabel row's width),
    or the largest class label of any split plus one, a binary task taking
    one logit."""
    y0 = np.atleast_1d(splits.train[0].y)
    cfg.share.dim_in = int(splits.train[0].node_feat.shape[-1])
    tt = cfg.dataset.task_type
    if tt in ("regression", "classification_multilabel"):
        dim_out = int(y0.reshape(-1).shape[0])
    elif tt in ("classification", "classification_binary"):
        dim_out = 1 + max(int(np.nanmax(np.atleast_1d(g.y).astype(np.float64)))
                          for g in splits.all_graphs)
        if dim_out == 2 and tt == "classification_binary":
            dim_out = 1
    else:
        raise NotImplementedError(
            f"dataset.task_type={tt!r} is not ported (ROADMAP Queue 1 "
            "item 17)")
    cfg.share.dim_out = max(1, dim_out)
    return cfg.share.dim_out


def create_loaders(cfg: CfgNode, splits: DatasetSplits,
                   device) -> Dict[str, DeviceLoader]:
    """Per-split loaders sharing one (max_nodes, edge block) cap; a node
    task's loaders carry one label per node. A transductive split (its
    graphs carry a ``split_mask``) is one batch of the graphs it has: the
    JAX driver collates it into ``train.batch_size`` graph slots on the host
    (``graphgps_tpu/driver.py:113-121``), all but one of them empty; every
    real node gets the same values either way (masked loss, no norm across
    graphs), for a B-fold smaller attention and node tensors."""
    if cfg.dataset.task not in ("graph", "node"):
        raise NotImplementedError(
            f"dataset.task={cfg.dataset.task!r}: the port runs graph and "
            "node tasks (edge and link tasks: ROADMAP Queue 1 item 17)")
    n_cap, e_cap = choose_caps(splits.all_graphs)
    max_nodes = cfg.dataset.max_nodes or n_cap
    out = {}
    for name, graphs in (("train", splits.train), ("val", splits.val),
                         ("test", splits.test)):
        if graphs:
            bs = cfg.train.batch_size
            if "split_mask" in graphs[0].extras:
                bs = len(graphs)
            max_edges = cfg.dataset.max_edges or round_up(bs * e_cap, 128)
            out[name] = DeviceLoader(graphs, bs, device, max_nodes=max_nodes,
                                     max_edges=max_edges,
                                     shuffle=(name == "train"), seed=cfg.seed,
                                     y_graph_level=cfg.dataset.task == "graph")
    cfg.share.num_splits = len(out)
    return out


def run_single(cfg: CfgNode, run_dir: str, device: torch.device,
               prepare_model: Optional[Callable] = None) -> Dict:
    """One (seed, split) run. ``prepare_model(model)``, when given, sees the
    seeded model on its device before the run. ``custom`` trains: the model
    in training mode, and one host generator seeded from ``cfg.seed`` draws
    every dropout seed."""
    mode = cfg.train.mode
    if mode not in TRAIN_MODES:
        raise NotImplementedError(
            f"train.mode={mode!r} is not ported ({sorted(TRAIN_MODES)}; "
            "ROADMAP Queue 1 item 17)")
    if cfg.pretrained.dir:
        raise NotImplementedError(
            "pretrained.dir: loading a checkpoint is not ported yet (ROADMAP "
            "Queue 1 item 17)")
    os.makedirs(run_dir, exist_ok=True)
    splits = load_dataset(cfg)
    dim_out = infer_dims(cfg, splits)
    loaders = create_loaders(cfg, splits, device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, dim_out)
    model = model.to(device).train(mode == "custom")
    cfg.share["params"] = sum(p.numel() for p in model.parameters())
    log.info("model %s params %d on %s", cfg.model.type, cfg.share.params,
             device)
    if prepare_model is not None:
        prepare_model(model)
    gen = torch.Generator().manual_seed(cfg.seed)
    return TRAIN_MODES[mode](cfg, loaders, model, run_dir, gen)


def main(argv=None, prepare_model: Optional[Callable] = None) -> Dict:
    """Returns {run_id: history}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = new_cfg()
    load_cfg(cfg, args.cfg_file)
    if args.opts:
        update_from_list(cfg, args.opts)
    validate_cfg(cfg)
    set_out_dir(cfg, args.cfg_file)
    os.makedirs(cfg.out_dir, exist_ok=True)
    dump_cfg(cfg, os.path.join(cfg.out_dir, cfg.cfg_dest))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    histories = {}
    for run_id, seed, split_index in zip(*run_loop_settings(cfg, args.repeat)):
        cfg.seed = seed
        cfg.run_id = run_id
        cfg.dataset.split_index = split_index
        run_dir = os.path.join(cfg.out_dir, str(run_id))
        log.info("=== run %s (seed %d, split %d) ===", run_id, seed,
                 split_index)
        histories[run_id] = run_single(cfg, run_dir, device, prepare_model)
    return histories
