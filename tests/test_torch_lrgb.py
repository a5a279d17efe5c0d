"""What multilabel graph tasks and the long-range recipes bring to the port,
against the JAX package on the CPU:

- the multilabel metrics (``ap`` and ``auc`` over the label columns with
  both classes present, NaN targets left out) to 1e-12, with tied scores,
  NaN targets and a column of one class;
- multilabel binary cross-entropy and multi-target ``l1``, value and
  gradient, on padded rows with NaN targets, and JAX's refusal of
  ``size_average: sum`` for the NaN-filtered loss;
- the stand-ins graph for graph and target for target, NaN positions
  included: peptides-functional and -structural, the zinc-like multilabel
  branch (ogbg-molpcba's) and COCO's fallback to the voc-like one;
- the default graph head on the same weights;
- the recipe's model in evaluation and one training step, at 2 layers, for
  peptides-func-GPS (batch 8, graphs of 20-150 atoms: the wide attention
  and the GatedGCN core past 128 node slots), ogbg-molpcba-GPS+RWSE at d =
  128 (the merged path; the step at dropout 0, as ``test_torch_train.py``:
  the merged front's masks in JAX come from flax's RNG), ogbg-molhiv
  GPS+RWSEdev at d = 72 (dropout 0.3 / 0.5 through ``Patches`` of
  ``test_torch_unmerged.py``: deferred tails) and cocosuperpixels-GPS (8
  heads of 12 columns);
- the seven multilabel and long-range configs (ROADMAP Queue 1 step 3),
  each through ``driver.main`` for one epoch, and the neighbours that
  still refuse.

Long graphs compare as ``tests/test_torch_voc.py`` compares VOC: the JAX
``DeviceLoader`` built at the port's caps, the JAX wide rung (TPU only) off,
its dense attention handed the port's mask (``Rungs``), the LapPE signs
fixed. Tolerances, f32: losses 1e-6, models rtol = atol = 1e-4 with a
gradient's atol scaled by its tensor's largest entry (``PERF.md`` §2)."""
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import small_cfgs
from tests.test_torch_layer import randomize_norms
from tests.test_torch_main import ROOT

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
LR = 1e-3
# Adam's first step moves an entry by about lr·sign(g) whatever |g|: where
# the gradient check leaves g's sign open, the two packages' steps may part
# by up to 2·lr. A wrong update rule, rate or batch would move most entries
SMALL_STEP_ENTRIES = 2
SIGNS = np.array([1, 0, 0, 1, 1, 1, 0, 1, 0, 0])   # LapPE, max_freqs 10

PEPTIDES_FUNC_CFG = str(ROOT / "configs/GPS/peptides-func-GPS.yaml")
PEPTIDES_STRUCT_CFG = str(ROOT / "configs/GPS/peptides-struct-GPS.yaml")
MOLPCBA_CFG = str(ROOT / "configs/GPS/ogbg-molpcba-GPS+RWSE.yaml")
RWSEDEV_CFG = str(ROOT / "configs/GPS/ogbg-molhiv-GPS+RWSEdev.yaml")
COCO_CFG = str(ROOT / "configs/GPS/cocosuperpixels-GPS.yaml")
# 40 graphs: train 32 (4 batches of 8), val 4 and test 4
SMALL = ["gt.layers", "2", "train.batch_size", "8",
         "dataset.synth_num_graphs", "40"]
MOL_SMALL = [*SMALL, "dataset.synth_max_nodes", "14"]
# ogbg-molpcba at d = 128, a multiple of 128 (the merged path), 4 labels
MOLPCBA_SMALL = [*MOL_SMALL, "gt.dim_hidden", "128", "gnn.dim_inner", "128",
                 "dataset.synth_num_tasks", "4"]
# COCO on 30 voc-like graphs of 130-160 nodes (160 node slots: past 128,
# the wide attention) in batches of 6
COCO_SMALL = ["gt.layers", "2", "train.batch_size", "6",
              "dataset.synth_num_graphs", "30", "dataset.synth_min_nodes",
              "130", "dataset.synth_max_nodes", "160",
              "dataset.synth_num_tasks", "5"]


# ---------------------------------------------------------------------------
# metrics and losses

def _multilabel_case(n=120, T=6, seed=0):
    """Logits (n, T) with ties, 0/1 labels with NaN entries; column 1 has
    only positives, column 4 only negatives (both left out of the means);
    a row mask of the real rows."""
    rng = np.random.default_rng(seed)
    pred = np.round(2.0 * rng.standard_normal((n, T)), 1).astype(np.float32)
    true = (rng.random((n, T)) < 0.35).astype(np.float32)
    true[:, 1], true[:, 4] = 1.0, 0.0
    true[rng.random((n, T)) < 0.15] = np.nan
    mask = rng.random(n) < 0.8
    return pred, true, mask


def test_multilabel_metrics_match_jax():
    """``ap`` and ``auc`` of ``compute_task_metrics``, and each column's AP
    and ROC-AUC, equal to 1e-12: ties (scores rounded to 0.1) counted at
    the last index of each block, NaN targets left out, one-class columns
    out of the mean; a column without positives gives AP 0."""
    from graphgps_tpu import metrics as jm
    from graphgps_torch import metrics as tm

    pred, true, _ = _multilabel_case()
    want = jm.compute_task_metrics("classification_multilabel", pred, true)
    got = tm.compute_task_metrics("classification_multilabel", pred, true)
    assert list(got) == ["ap", "auc"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
        assert 0.0 < got[k] < 1.0
    for c in range(pred.shape[1]):
        assert tm.average_precision(pred[:, c], true[:, c]) == \
            pytest.approx(jm.average_precision(pred[:, c], true[:, c]),
                          abs=1e-12)
    assert tm.average_precision(pred[:, 4], true[:, 4]) == 0.0
    for fn in ("ogb_ap_multilabel", "ogb_rocauc_multilabel"):
        a = getattr(tm, fn)(pred[:, [1, 4]], true[:, [1, 4]])
        assert a == getattr(jm, fn)(pred[:, [1, 4]], true[:, [1, 4]]) == 0.0


@pytest.mark.parametrize("cfg_path,size_average", [
    (PEPTIDES_FUNC_CFG, "mean"), (PEPTIDES_STRUCT_CFG, "mean"),
    (PEPTIDES_STRUCT_CFG, "sum")])
def test_lrgb_losses_match_jax(cfg_path, size_average):
    """The recipe's loss through both packages' ``compute_loss``:
    peptides-func's ``cross_entropy`` on a multilabel task is BCE with
    logits over the real rows' non-NaN labels; peptides-struct's ``l1``
    over its 11 targets takes every column of a real row, NaN targets as 0
    (``_masked_mean``). Value (1e-6) and the gradient w.r.t. the
    predictions (1e-6)."""
    from graphgps_tpu.models.losses import compute_loss as jloss
    from graphgps_torch.train.loop import compute_loss

    jcfg, tcfg = small_cfgs("model.size_average", size_average,
                            cfg_path=cfg_path, small=SMALL)
    T = 10 if cfg_path == PEPTIDES_FUNC_CFG else 11
    pred, true, mask = _multilabel_case(64, T, seed=1)
    if T == 11:
        true = np.where(np.isnan(true), np.nan,
                        np.random.default_rng(2).standard_normal(true.shape)
                        ).astype(np.float32)
    want, wgrad = jax.value_and_grad(
        lambda p: jloss(jcfg, p, jnp.asarray(true), jnp.asarray(mask)))(
            jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = compute_loss(tcfg, tp, torch.from_numpy(true),
                       torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-6)
    assert not np.isnan(float(got.detach()))
    assert (tp.grad.numpy()[~mask] == 0).all()


def test_multilabel_loss_refuses_sum():
    """``size_average: sum`` on the NaN-filtered loss raises in both
    packages: its denominator depends on the data."""
    from graphgps_tpu.models.losses import compute_loss as jloss
    from graphgps_torch.train.loop import compute_loss

    jcfg, tcfg = small_cfgs("model.size_average", "sum",
                            cfg_path=PEPTIDES_FUNC_CFG, small=SMALL)
    pred, true, mask = _multilabel_case(16, 10)
    with pytest.raises(ValueError, match="size_average"):
        jloss(jcfg, jnp.asarray(pred), jnp.asarray(true), jnp.asarray(mask))
    with pytest.raises(ValueError, match="size_average"):
        compute_loss(tcfg, torch.from_numpy(pred), torch.from_numpy(true),
                     torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# the stand-ins

def _jax_splits(jcfg):
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload

    return jload(jcfg)


def _same_graphs(jsplits, tsplits, pe=()):
    for part in ("train", "val", "test"):
        jg, tg = getattr(jsplits, part), getattr(tsplits, part)
        assert len(jg) == len(tg) > 0, part
        for a, b in zip(jg, tg):
            for name in ("node_feat", "edge_index", "edge_feat", "y"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            for k in pe:
                np.testing.assert_array_equal(a.pe[k], b.pe[k], err_msg=k)


@pytest.mark.parametrize("cfg_path,small,what", [
    (PEPTIDES_FUNC_CFG, SMALL, "peptides-functional"),
    (PEPTIDES_STRUCT_CFG, SMALL, "peptides-structural"),
    (MOLPCBA_CFG, MOLPCBA_SMALL, "zinc-like multilabel"),
    (COCO_CFG, COCO_SMALL, "voc-like")])
def test_standins_match_jax(cfg_path, small, what):
    """The JAX loader's fallback graph for graph: features, edges, targets
    (dtypes and NaN positions included) and the PE arrays. Peptides:
    20-150 atoms, 9 integer node and 3 edge columns, 10 labels with NaN or
    11 regression targets; ogbg-molpcba: the zinc-like graphs with one 0/1
    label per task and NaN; COCO: the voc-like ring graphs."""
    from graphgps_torch.data.datasets import load_dataset

    jcfg, tcfg = small_cfgs(cfg_path=cfg_path, small=small)
    jsplits, tsplits = _jax_splits(jcfg), load_dataset(tcfg)
    pe = ["EigVecs"] if "LapPE" in tcfg.dataset.node_encoder_name else []
    pe += ["pestat_RWSE"] if "RWSE" in tcfg.dataset.node_encoder_name else []
    _same_graphs(jsplits, tsplits, pe)
    graphs = tsplits.all_graphs
    if what.startswith("peptides"):
        sizes = [g.num_nodes for g in graphs]
        assert 20 <= min(sizes) and max(sizes) <= 150
        assert graphs[0].node_feat.shape[1] == 9
        assert graphs[0].edge_feat.shape[1] == 3
        assert graphs[0].y.shape == ((10,) if "func" in what else (11,))
    if what == "zinc-like multilabel":
        assert graphs[0].y.shape == (4,)
    if "func" in what or "multilabel" in what:
        y = np.stack([g.y for g in graphs])
        assert np.isnan(y).any() and set(np.unique(y[~np.isnan(y)])) == \
            {0.0, 1.0}
    if what == "voc-like":
        assert graphs[0].node_feat.shape[1] == 14


# ---------------------------------------------------------------------------
# the default graph head

@pytest.mark.parametrize("pooling,layers", [("mean", 1), ("add", 3)])
def test_default_head_matches_jax(pooling, layers):
    """``GNNGraphHead`` (pool, then an MLP of ``layers`` Dense with relu
    between) on the same weights, through the weight bridge's mapping of
    ``GNNGraphHead_0/MLP_0``, on a partial batch."""
    from graphgps_tpu.models.heads import GNNGraphHead as JaxHead
    from graphgps_torch.models.heads import GNNGraphHead
    from graphgps_torch.weights import state_dict_from_flax
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_layer import torch_batch

    batch, x, *_ = _blocked_batch(6, 16, 32, 96, seed=3)
    jh = JaxHead(dim_in=96, dim_out=10, pooling=pooling, layers=layers)
    var = jh.init(jax.random.PRNGKey(2), batch, x, False)
    want, _ = jh.apply(var, batch, x, False)

    head = GNNGraphHead(96, 10, pooling=pooling, layers=layers)
    sd = state_dict_from_flax({"FeatureEncoder_0": {},
                               "GNNGraphHead_0": var["params"]})
    head.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got, _ = head(torch_batch(batch), torch.from_numpy(np.array(x)))
    assert got.shape == (6, 10) and len(head.mlp.layers) == layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the recipes' models against JAX's

def _loaders(cfg_path, small, *extra):
    """(jcfg, JAX DeviceLoaders at the port's caps, tcfg, tsplits, port
    loaders)."""
    from graphgps_tpu.data.device_loader import DeviceLoader as JaxLoader
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, cfg_path=cfg_path, small=small)
    jsplits, tsplits = _jax_splits(jcfg), load_dataset(tcfg)
    tl = create_loaders(tcfg, tsplits, "cpu")
    ref = tl["train"]
    jl = {name: JaxLoader(getattr(jsplits, name), ref.batch_size,
                          max_nodes=ref.max_nodes,
                          max_edges=ref.batch_size * ref.arenas.edge_cap,
                          shuffle=(name == "train"), seed=jcfg.seed,
                          y_graph_level=tcfg.dataset.task == "graph")
          for name in tl}
    return jcfg, jl, tcfg, tsplits, tl


def _fixed_signs(monkeypatch):
    """Both packages' LapPE sign flips fixed to SIGNS (1 keep, 0 flip)."""
    from graphgps_torch.models import encoders

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(SIGNS > 0))
    monkeypatch.setattr(encoders, "draw_signs",
                        lambda gen, K: torch.from_numpy(SIGNS * 2.0 - 1.0)
                        .float())


# recipe: (config, small size, dim_out, overrides of the training step)
RECIPES = {
    "peptides-func": (PEPTIDES_FUNC_CFG, SMALL, 10, ()),
    "ogbg-molpcba": (MOLPCBA_CFG, MOLPCBA_SMALL, 4,
                     ("gt.dropout", "0.0", "gt.attn_dropout", "0.0")),
    "ogbg-molhiv-RWSEdev": (RWSEDEV_CFG, MOL_SMALL, 1, ()),
    "cocosuperpixels": (COCO_CFG, COCO_SMALL, 5, ()),
}


def _patch(monkeypatch, name):
    """The masks and seeds both packages take: the port's attention mask
    and seeds on the long graphs (``Rungs``), the unmerged path's four
    seeds and masks at d = 72 (``Patches``), the merged front on both sides
    at d = 128; LapPE's signs fixed."""
    from tests.test_torch_unmerged import Patches
    from tests.test_torch_wide import Rungs

    _fixed_signs(monkeypatch)
    if name == "ogbg-molpcba":
        monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
        return None
    if name == "ogbg-molhiv-RWSEdev":
        return Patches(monkeypatch, 72)
    return Rungs(monkeypatch)


def _jax_model(jcfg, dim_out, jb):
    from graphgps_tpu.models.networks import build_model as jbuild

    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    # jitted: an eager init runs the Pallas kernels op by op in interpret
    # mode, some ten times slower
    var = jax.jit(lambda b: jmodel.init(
        {"params": key, "dropout": key, "signflip": key}, b, False))(jb)
    return jmodel, randomize_norms(var["params"], var["batch_stats"], seed=9)


def _ffn_off_kinks(tcfg, dim_out, params, stats, tb, margin=1e-4):
    """``params`` with each GPS layer's FFN bias (``GPSLayer_<i>/Dense_0``)
    moved by 10·margin at every relu unit whose pre-activation lies within
    ``margin`` of 0 on a real row of ``tb`` in the port's training step,
    until none does. Two summation orders can put such a unit on either
    side of its kink, and its gradient column then parts by a few percent
    (as ``test_torch_san.py`` ``off_kinks`` does for LapPE's FFN)."""
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.ops.kernels import combine_ffn
    from graphgps_torch.weights import load_flax

    real = tb.node_mask
    pre = []

    def act_fn(name):
        assert name == "relu"
        return lambda z: (pre.append(z.detach()), torch.relu(z))[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(combine_ffn, "act_fn", act_fn)
        for _ in range(5):
            pre.clear()
            model = build_model(tcfg, dim_out).train()
            load_flax(model, params, stats)
            with torch.no_grad():
                model(tb, torch.Generator().manual_seed(0))
            # the FFN's pre-activations, 2d wide (the x-tail's are d wide)
            near = [(a[real].abs() < margin).any(0).numpy() for a in pre
                    if a.shape[-1] == 2 * tcfg.gt.dim_hidden]
            if not any(n.any() for n in near):
                return params
            for i, n in enumerate(near):
                dense = params[f"GPSLayer_{i}"]["Dense_0"]
                dense["bias"] = np.where(n, dense["bias"] + 10 * margin,
                                         dense["bias"]).astype(np.float32)
    raise AssertionError("FFN units stay near their relu kinks")


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_model_eval_matches_jax(monkeypatch, name):
    """The recipe at 2 layers in evaluation on a full and on a partial
    batch, on the same weights: predictions of every real graph (every
    real node on COCO) and the targets array for array (NaN included)."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.heads import GNNGraphHead
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train.loop import loss_mask
    from graphgps_torch.weights import load_flax

    cfg_path, small, want_out, _ = RECIPES[name]
    _patch(monkeypatch, name)
    jcfg, jl, tcfg, tsplits, tl = _loaders(cfg_path, small)
    dim_out = infer_dims(tcfg, tsplits)
    assert dim_out == want_out
    _, jb = next(iter(jl["val"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    model = build_model(tcfg, dim_out).eval()
    assert isinstance(model.head, GNNGraphHead) == (name != "cocosuperpixels")
    load_flax(model, params, stats)
    japply = jax.jit(lambda p, s, b: jmodel.apply(
        {"params": p, "batch_stats": s}, b, False))
    for split in ("val", "train"):
        _, jb = next(iter(jl[split]))
        _, tb = next(iter(tl[split]))
        want, jtrue = japply(params, stats, jb)
        with torch.no_grad():
            got, true = model(tb)
        m = loss_mask(tb, got).numpy()
        np.testing.assert_array_equal(true.numpy()[m], np.asarray(jtrue)[m])
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_train_step_matches_jax(monkeypatch, name):
    """One whole training step of the recipe at 2 layers on a train batch
    (the recipe's loss, adamW, clipping): loss, clipped gradients by the
    port's parameter names, updated parameters and running statistics, as
    ``test_torch_unmerged.py`` holds them: an entry whose JAX gradient is
    below 1e-7 (a bias a BatchNorm removes) may move by up to 2·lr either
    way, and at most ``SMALL_STEP_ENTRIES`` others may, each with a JAX
    gradient inside the gradient check's own tolerance of 0 (Adam's first
    step is about lr·sign(g), and that check leaves such a sign open).
    ogbg-molpcba's relu FFN units are moved off their kinks first
    (``_ffn_off_kinks``)."""
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_train import _clip

    cfg_path, small, _, extra = RECIPES[name]
    patches = _patch(monkeypatch, name)
    jcfg, jl, tcfg, tsplits, tl = _loaders(
        cfg_path, small, "optim.base_lr", str(LR), "optim.scheduler", "none",
        *extra)
    dim_out = infer_dims(tcfg, tsplits)
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    if name == "ogbg-molpcba":   # relu in the merged path's combine+FFN
        params = _ffn_off_kinks(tcfg, dim_out, params, stats, tb)
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    # the gradients (grad_step into a zero accumulator), then the update
    zero = jax.tree_util.tree_map(jnp.zeros_like, state.params)
    jg, bs, jloss, *_ = jax.jit(raw["grad"])(state, state.batch_stats, jb,
                                             rng, zero)
    state = jax.jit(raw["apply"], static_argnums=(3,))(state, jg, bs, 1)
    if name == "ogbg-molhiv-RWSEdev":
        assert patches.bits_calls > 0 and patches.bits_calls % 3 == 0
        assert patches.attn_calls > 0 and patches.combine.calls > 0

    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    named = dict(model.named_parameters())
    loss, *_ = train_step(tcfg, model, opt, tb, torch.Generator()
                          .manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)

    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats)).items()}
    old = {k: v.numpy() for k, v in state_dict_from_flax(params).items()}
    assert set(want_g) <= set(named)
    small_steps = []
    moved = 0.0
    for k, g in want_g.items():
        atol = ATOL * max(1e-3, np.abs(g).max())
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=RTOL,
                                   atol=atol, err_msg=f"grad {k}")
        noisy = np.abs(g) < 1e-7
        tol = np.where(noisy, 2 * LR, 1e-5 + 1e-5 * np.abs(new[k]) + 1e-2 * LR)
        diff = np.abs(named[k].detach().numpy() - new[k])
        assert (diff <= 2 * LR).all(), (k, float(diff.max()))
        # the rest of the 2·lr band: a sign the gradient check leaves open
        open_sign = np.abs(g) <= atol + RTOL * np.abs(g)
        for i in np.flatnonzero(diff > tol):
            assert open_sign.flat[i], (k, int(i), float(diff.flat[i]))
            small_steps.append((k, int(i), float(diff.flat[i]),
                                float(g.flat[i])))
        moved = max(moved, float(np.abs(new[k] - old[k])[~noisy]
                                 .max(initial=0.0)))
    assert moved > 0.5 * LR
    print(json.dumps(dict(recipe=name, small_step_entries=small_steps)))
    assert len(small_steps) <= SMALL_STEP_ENTRIES, small_steps
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the configs through the entry point

# the seven multilabel and long-range configs, each with the metric it
# selects by
CENSUS = [("GPS/ogbg-molhiv-GPS+RWSEdev", "auc"),
          ("GPS/ogbg-molpcba-GPS", "ap"), ("GPS/ogbg-molpcba-GPS+RWSE", "ap"),
          ("GPS/ogbg-molpcba-GPS-LapPE+RWSE", "ap"),
          ("GPS/peptides-func-GPS", "ap"), ("GPS/peptides-struct-GPS", "mae"),
          ("GPS/cocosuperpixels-GPS", "f1")]
# their neighbours that still refuse, each naming its ROADMAP item
REFUSED = [("GPS/ogbg-molpcba-GPS+SNDS", "item 16"),
           ("GPS/ogbg-molpcba-GPS-SNDS+RWSE", "item 16"),
           ("SAN/ogbg-molpcba-SAN", "item 17"),
           ("SAN/peptides-func-SAN", "item 17"),
           ("SAN/cocosuperpixels-SAN", "item 17"),
           ("GINE/peptides-func-GINE", "item 15"),
           ("GatedGCN/cocosuperpixels-GatedGCN", "item 15")]
CENSUS_SMALL = ["gt.layers", "2", "train.batch_size", "8",
                "dataset.synth_num_graphs", "40", "dataset.synth_max_nodes",
                "14", "optim.max_epoch", "1", "optim.num_warmup_epochs", "1"]


def _census_opts(name):
    if "molpcba" in name:
        return ["gt.dim_hidden", "128", "gnn.dim_inner", "128"]
    if "cocosuperpixels" in name:
        return ["dataset.synth_min_nodes", "130", "dataset.synth_max_nodes",
                "150", "dataset.synth_num_tasks", "5",
                "dataset.synth_num_graphs", "20", "train.batch_size", "4"]
    return []


@pytest.mark.parametrize("name,metric", CENSUS)
def test_lrgb_configs_train_one_epoch(tmp_path, caplog, name, metric):
    """Each config at 2 layers on its stand-in through ``driver.main`` in
    ``train.mode custom``: one train, val and test line with a finite loss
    and the metric the config selects by (ogbg-molpcba at d = 128, COCO on
    graphs of 130-150 nodes); the epoch's best line names that metric."""
    from graphgps_torch.driver import main

    cfg = str(ROOT / "configs" / f"{name}.yaml")
    with caplog.at_level(logging.INFO, logger="graphgps_torch"):
        hist = main(["--device", "cpu", "--cfg", cfg, *CENSUS_SMALL,
                     *_census_opts(name), "train.mode", "custom", "out_dir",
                     str(tmp_path)])[0]
    assert {k: [r["epoch"] for r in v] for k, v in hist.items()} == {
        "train": [0], "val": [0], "test": [0]}
    for rows in hist.values():
        assert all(np.isfinite(r["loss"]) and np.isfinite(r[metric])
                   for r in rows)
    assert f"best {metric}=" in caplog.text
    run = tmp_path / os.path.basename(name) / "0"
    assert (run / "train" / "stats.json").exists()


@pytest.mark.parametrize("name,item", REFUSED)
def test_lrgb_neighbours_refuse(tmp_path, name, item):
    """Their neighbours that still refuse, each naming its ROADMAP
    item: SignNet (16, before the ``batch_accumulation`` of
    ogbg-molpcba-GPS-SNDS+RWSE), ``batch_accumulation`` (17),
    ``custom_gnn`` (15)."""
    from graphgps_torch.driver import main

    cfg = str(ROOT / "configs" / f"{name}.yaml")
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        main(["--device", "cpu", "--cfg", cfg, *CENSUS_SMALL, "out_dir",
              str(tmp_path)])


@pytest.mark.parametrize("head,raises,says", [
    ("graphormer_graph", NotImplementedError, "outside a Graphormer"),
    ("ogb_code_graph", NotImplementedError, "ogbg-code2 sequence head"),
    ("infer_links", NotImplementedError, "an edge head"),
    ("defualt", ValueError, "is unknown")])
def test_head_refusals_name_the_head(head, raises, says):
    """A JAX head the stacks do not build yet names what it is and its
    ROADMAP item; a name no package has (a typo) is called unknown, with
    the port's heads listed."""
    from graphgps_torch.models.networks import HEADS, build_model

    _, cfg = small_cfgs("gnn.head", head)
    with pytest.raises(raises) as err:
        build_model(cfg, 1)
    msg = str(err.value)
    assert says in msg and str(sorted(HEADS)) in msg
    assert ("ROADMAP Queue 1 item 17" in msg) == (raises is NotImplementedError)
