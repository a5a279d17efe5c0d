"""The port's data path against the JAX package's: the same synthetic
PCQM4Mv2 stand-in, the same RWSE (``graphgps_tpu/pe/host.py:92``), and
batch for batch the same arrays as the JAX ``DeviceLoader`` -- a shuffled
train epoch and a partial last batch."""
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CFG = str(pathlib.Path(__file__).resolve().parents[1]
          / "configs/GPS/pcqm4m-GPSdeep+RWSE.yaml")
# 40 graphs: train 32 (4 batches of 8), val 4 and test 4 (one partial batch)
SMALL = ["gt.layers", "2", "gt.dim_hidden", "128", "gnn.dim_inner", "128",
         "gt.n_heads", "4", "train.batch_size", "8",
         "dataset.synth_num_graphs", "40", "dataset.synth_max_nodes", "14",
         "train.mode", "inference-only"]


MOLHIV_CFG = str(pathlib.Path(CFG).with_name("ogbg-molhiv-GPS+RWSE.yaml"))
# the ogbg-molhiv recipe (d = 64, 4 heads) cut to 2 layers; same 40 graphs
MOLHIV_SMALL = ["gt.layers", "2", "train.batch_size", "8",
                "dataset.synth_num_graphs", "40", "dataset.synth_max_nodes",
                "14"]


def small_cfgs(*extra, cfg_path=CFG, small=SMALL):
    """(jax_cfg, torch_cfg) of a recipe (by default GPS-deep) cut to test
    size."""
    from graphgps_tpu.config import config as jc
    from graphgps_torch import config as tc

    out = []
    for mod in (jc, tc):
        cfg = mod.new_cfg()
        mod.load_cfg(cfg, cfg_path)
        mod.update_from_list(cfg, list(small) + list(extra))
        out.append(cfg)
    return out


def both_loaders(*extra, **which):
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.driver import create_loaders as jloaders
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, **which)
    jsplits, tsplits = jload(jcfg), load_dataset(tcfg)
    return (jcfg, jsplits, jloaders(jcfg, jsplits),
            tcfg, tsplits, create_loaders(tcfg, tsplits, "cpu"))


def test_rwse_matches_jax():
    from graphgps_tpu.data.graph import Graph as JGraph
    from graphgps_tpu.pe.host import rwse as jrwse
    from graphgps_torch.data.datasets import zinc_like
    from graphgps_torch.pe.host import rwse

    _, tcfg = small_cfgs()
    graphs = zinc_like(tcfg).all_graphs
    times = list(range(1, 17))
    for g in graphs:
        jg = JGraph(node_feat=g.node_feat, edge_index=g.edge_index)
        np.testing.assert_array_equal(rwse(g, times), jrwse(jg, times))


def test_dataset_matches_jax():
    _, jsplits, _, _, tsplits, _ = both_loaders()
    for part in ("train", "val", "test"):
        jg, tg = getattr(jsplits, part), getattr(tsplits, part)
        assert len(jg) == len(tg)
        for a, b in zip(jg, tg):
            np.testing.assert_array_equal(a.node_feat, b.node_feat)
            np.testing.assert_array_equal(a.edge_index, b.edge_index)
            np.testing.assert_array_equal(a.edge_feat, b.edge_feat)
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.pe["pestat_RWSE"],
                                          b.pe["pestat_RWSE"])


@pytest.mark.parametrize("split", ["train", "val"])
def test_loader_matches_jax_device_loader(split):
    *_, jl, _, _, tl = both_loaders()
    jl, tl = jl[split], tl[split]
    assert len(jl) == len(tl)
    n = 0
    for (jreal, jb), (treal, tb) in zip(jl, tl):
        n += 1
        assert jreal == treal
        assert (jb.num_graphs, jb.max_nodes, jb.edge_block) == \
            (tb.num_graphs, tb.max_nodes, tb.edge_block)
        for name in ("node_feat", "edge_feat", "senders", "receivers",
                     "node_mask", "edge_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name)
        np.testing.assert_array_equal(tb.pe["pestat_RWSE"].numpy(),
                                      np.asarray(jb.pe["pestat_RWSE"]))
        if split == "val":   # 4 graphs in a batch of 8
            assert treal == 4 and not tb.graph_mask[4:].any()
            assert torch.isnan(tb.y[4:]).all()
    assert n == len(tl)
