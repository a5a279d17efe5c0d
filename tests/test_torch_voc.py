"""What the VOC-superpixels recipe (``configs/GPS/vocsuperpixels-GPS.yaml``:
``VOCNode+LapPE`` and ``VOCEdge`` encoders, 4 x 96 GPS layers on graphs of
hundreds of nodes, ``inductive_node`` head, ``weighted_cross_entropy``,
macro ``f1``) brings to the port, against the JAX package on the CPU: the
synthetic stand-in graph for graph, the Laplacian eigenpairs, the loader's
float features, node labels, ``EigVecs`` and ``EigVals`` against the JAX
``DeviceLoader`` array for array, the losses and the multiclass metrics, the
LapPE encoder with both raw norms and with post layers, and the recipe cut to
2 layers in evaluation and for two whole train steps; then the entry point on
the CPU.

The JAX package's ``create_loaders`` collates this recipe on the host (it
leaves ``EigVals``-like extras to the host path); the tests build the JAX
``DeviceLoader`` directly, which lays the same arrays out per graph and so
lets ``GatedGCNLayer`` take its edge-gate kernel (in Pallas interpret mode;
the tests assert that it ran). On the CPU the JAX layer computes the wide
attention through its dense path.

Both packages get the same LapPE signs (``jax.random.bernoulli`` and the
port's ``draw_signs`` patched from here) and the same attention masks
(``Rungs`` of ``test_torch_wide.py``). Tolerances, f32: losses 1e-6, encoders
1e-5, the model rtol = atol = 1e-4 with a gradient's atol scaled by its
tensor's largest entry (``test_torch_unmerged.py``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import small_cfgs
from tests.test_torch_layer import randomize_norms
from tests.test_torch_main import ROOT
from tests.test_torch_tasks import _run_cli, _stats
from tests.test_torch_wide import Rungs

torch.set_num_threads(2)

VOC_CFG = str(ROOT / "configs/GPS/vocsuperpixels-GPS.yaml")
# 30 graphs of 130-250 nodes (248 node slots, 512 edge slots) in batches of
# 6: train 24 (4 batches), val 3 and test 3 (one partial batch each)
VOC_SMALL = ["gt.layers", "2", "train.batch_size", "6",
             "dataset.synth_num_graphs", "30", "dataset.synth_min_nodes",
             "130", "dataset.synth_max_nodes", "250",
             "dataset.synth_num_tasks", "5"]
RTOL = ATOL = 1e-4
SIGNS = np.array([1, 0, 0, 1, 1, 1, 0, 1, 0, 0])   # 1: keep, 0: flip


def voc_loaders(*extra):
    """(jcfg, jsplits, JAX device loaders, tcfg, tsplits, port loaders)."""
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.data.device_loader import DeviceLoader as JaxLoader
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, cfg_path=VOC_CFG, small=VOC_SMALL)
    jsplits, tsplits = jload(jcfg), load_dataset(tcfg)
    tl = create_loaders(tcfg, tsplits, "cpu")
    ref = tl["train"]
    jl = {name: JaxLoader(getattr(jsplits, name), ref.batch_size,
                          max_nodes=ref.max_nodes,
                          max_edges=ref.batch_size * ref.arenas.edge_cap,
                          shuffle=(name == "train"), seed=jcfg.seed,
                          y_graph_level=False)
          for name in tl}
    return jcfg, jsplits, jl, tcfg, tsplits, tl


@pytest.fixture(scope="module")
def loaders():
    return voc_loaders()


def test_voc_dataset_matches_jax(loaders):
    """The stand-in of the JAX loader's fallback: float node features
    (n, 14), float edge features (E, 2), one integer class per node, and the
    10 smallest Laplacian eigenpairs (both run the same numpy ``eigh``, so
    the arrays are equal, signs included)."""
    _, jsplits, _, tcfg, tsplits, _ = loaders
    assert tcfg.dataset.format == "PyG-VOCSuperpixels"
    for part in ("train", "val", "test"):
        jg, tg = getattr(jsplits, part), getattr(tsplits, part)
        assert len(jg) == len(tg) > 0
        for a, b in zip(jg, tg):
            assert b.node_feat.dtype == np.float32 and b.node_feat.shape[1] == 14
            assert b.edge_feat.shape == (2 * b.num_nodes, 2)
            assert np.issubdtype(b.y.dtype, np.integer) and b.y.shape == (b.num_nodes,)
            for name in ("node_feat", "edge_index", "edge_feat", "y"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            np.testing.assert_array_equal(a.pe["EigVecs"], b.pe["EigVecs"])
            np.testing.assert_array_equal(a.extras["EigVals"],
                                          b.extras["EigVals"])
            assert b.extras["EigVals"].shape == (1, 10)


@pytest.mark.parametrize("norm,vec", [("none", "L2"), ("sym", "L1"),
                                      ("sym", "abs-max")])
def test_lap_eig_matches_jax(norm, vec):
    """``lap_eig`` on a graph of fewer nodes than frequencies (NaN padding)
    and on a larger one, under both Laplacians and three normalisations."""
    from graphgps_tpu.data.graph import Graph as JGraph
    from graphgps_tpu.pe.host import lap_eig as jlap
    from graphgps_torch.data.graph import Graph
    from graphgps_torch.pe.host import lap_eig

    rng = np.random.default_rng(0)
    for n in (6, 30):
        s = np.arange(n)
        ei = np.stack([np.concatenate([s, (s + 1) % n, rng.integers(0, n, 5)]),
                       np.concatenate([(s + 1) % n, s, rng.integers(0, n, 5)])])
        x = np.zeros((n, 1), np.float32)
        want = jlap(JGraph(node_feat=x, edge_index=ei), 10, norm, vec)
        got = lap_eig(Graph(node_feat=x, edge_index=ei), 10, norm, vec)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert np.isnan(got[0]).sum() == max(0, 10 - n)


@pytest.mark.parametrize("split", ["train", "val"])
def test_voc_loader_matches_jax_device_loader(loaders, split):
    """Batch for batch against the JAX ``DeviceLoader`` with per-node
    labels: float features, node labels (0 on padded slots), ``EigVecs``
    among ``pe``, ``EigVals`` among ``extras``; the real-node counts."""
    *_, jl, _, _, tl = loaders
    n = 0
    for (jreal, jb), (treal, tb) in zip(jl[split], tl[split]):
        n += 1
        assert jreal == treal
        assert (jb.num_graphs, jb.max_nodes, jb.edge_block) == \
            (tb.num_graphs, tb.max_nodes, tb.edge_block) == (6, 248, 512)
        assert tb.node_feat.dtype == tb.edge_feat.dtype == torch.float32
        assert tb.y.dtype == torch.int32 and tb.y.shape == (6 * 248,)
        for name in ("node_feat", "edge_feat", "senders", "receivers",
                     "node_mask", "edge_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name)
        np.testing.assert_array_equal(tb.pe["EigVecs"].numpy(),
                                      np.asarray(jb.pe["EigVecs"]))
        np.testing.assert_array_equal(tb.extras["EigVals"].numpy(),
                                      np.asarray(jb.extras["EigVals"]))
        counts = tb.node_mask.reshape(6, 248).sum(1)
        assert tb.counts.dtype == torch.int32
        np.testing.assert_array_equal(tb.counts.numpy(), counts.numpy())
        if split == "val":   # 3 graphs in a batch of 6
            assert treal == 3 and not tb.graph_mask[3:].any()
            assert (tb.counts[3:] == 0).all() and (tb.y[3 * 248:] == 0).all()
    assert n == len(tl[split]) > 0


def _class_case(n=300, C=5, seed=0):
    rng = np.random.default_rng(seed)
    pred = (2.0 * rng.standard_normal((n, C))).astype(np.float32)
    true = rng.integers(0, C - 1, n).astype(np.int32)   # one class absent
    mask = rng.random(n) < 0.8
    return pred, true, mask


@pytest.mark.parametrize("loss_fun,size_average", [
    ("weighted_cross_entropy", "mean"), ("cross_entropy", "mean"),
    ("cross_entropy", "sum")])
def test_multiclass_losses_match_jax(loss_fun, size_average):
    """Loss value and its gradient w.r.t. the logits through both packages'
    ``compute_loss`` under a node mask, labels as (R,) and as (R, 1)."""
    from graphgps_tpu.models.losses import compute_loss as jloss
    from graphgps_torch.train.loop import compute_loss

    jcfg, tcfg = small_cfgs("model.loss_fun", loss_fun, "model.size_average",
                            size_average, cfg_path=VOC_CFG, small=VOC_SMALL)
    pred, true, mask = _class_case()
    for t in (true, true[:, None]):
        want, wgrad = jax.value_and_grad(
            lambda p: jloss(jcfg, p, jnp.asarray(t), jnp.asarray(mask)))(
                jnp.asarray(pred))
        tp = torch.from_numpy(pred).requires_grad_()
        got = compute_loss(tcfg, tp, torch.from_numpy(t),
                           torch.from_numpy(mask))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-5, atol=1e-6 * (
                                       300 if size_average == "sum" else 1))


def test_weighted_cross_entropy_refuses_sum():
    from graphgps_torch.train.loop import compute_loss

    _, tcfg = small_cfgs("model.size_average", "sum", cfg_path=VOC_CFG,
                         small=VOC_SMALL)
    pred, true, mask = _class_case(20)
    with pytest.raises(ValueError, match="size_average"):
        compute_loss(tcfg, torch.from_numpy(pred), torch.from_numpy(true),
                     torch.from_numpy(mask))


def test_multiclass_metrics_match_jax():
    """accuracy, accuracy-SBM and the macro f1 over the classes present,
    equal to 1e-12; integer predictions give no f1, as in JAX."""
    from graphgps_tpu.metrics import compute_task_metrics as jm
    from graphgps_torch.metrics import compute_task_metrics

    pred, true, _ = _class_case(500, 7, seed=2)
    want = jm("classification", pred, true)
    got = compute_task_metrics("classification", pred, true)
    assert list(got) == ["accuracy", "accuracy-SBM", "f1"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    assert 0.0 < got["f1"] < 1.0
    labels = pred.argmax(-1)
    assert compute_task_metrics("classification", labels, true) == \
        jm("classification", labels, true)


def _patch_signs(monkeypatch):
    """Both packages flip the eigenvectors where SIGNS is 0."""
    from graphgps_torch.models import encoders

    calls = {"jax": 0, "torch": 0}

    def bernoulli(key, p=0.5, shape=None):
        calls["jax"] += 1
        assert tuple(shape) == SIGNS.shape
        return jnp.asarray(SIGNS > 0)

    def draw_signs(gen, K):
        calls["torch"] += 1
        return torch.from_numpy(SIGNS * 2.0 - 1.0).float()

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(encoders, "draw_signs", draw_signs)
    return calls


@pytest.mark.parametrize("raw_norm,layers,post,train", [
    ("none", 2, 0, False), ("none", 2, 0, True), ("BatchNorm", 3, 1, True),
    ("BatchNorm", 1, 2, False)])
def test_lappe_encoder_matches_jax(monkeypatch, loaders, raw_norm, layers,
                                   post, train):
    """The whole FeatureEncoder (``VOCNode+LapPE``, ``VOCEdge``) on a
    partial batch: x and e, in evaluation and in training (sign flip, the raw
    norm's batch statistics and their update), with the DeepSet at 1 to 3
    layers and 0 to 2 post layers."""
    from graphgps_tpu.config.config import FrozenCfg
    from graphgps_tpu.models.networks import FeatureEncoder as JaxEncoder
    from graphgps_torch.models.encoders import FeatureEncoder
    from graphgps_torch.weights import _encoder_state_dict, to_torch

    calls = _patch_signs(monkeypatch)
    *_, jl, _, _, tl = loaders
    jcfg, tcfg = small_cfgs(
        "posenc_LapPE.raw_norm_type", raw_norm, "posenc_LapPE.layers",
        str(layers), "posenc_LapPE.post_layers", str(post), cfg_path=VOC_CFG,
        small=VOC_SMALL)
    _, jb = next(iter(jl["val"]))
    _, tb = next(iter(tl["val"]))
    jenc = JaxEncoder(cfg=FrozenCfg(jcfg), dim_h=96)
    key = jax.random.PRNGKey(1)
    var = jenc.init({"params": key, "signflip": key}, jb, False)
    params, stats = randomize_norms(var["params"],
                                    var.get("batch_stats", {}), seed=3)
    (jx, je), mut = jenc.apply({"params": params, "batch_stats": stats}, jb,
                               train, rngs={"signflip": key},
                               mutable=["batch_stats"])

    enc = FeatureEncoder(tcfg, 96).train(train)
    sd = {}
    _encoder_state_dict(sd, params, stats)
    enc.load_state_dict({k[len("encoder."):]: v
                         for k, v in to_torch(sd).items()})
    with torch.no_grad():
        tx, te = enc(tb, torch.Generator().manual_seed(0))
    assert calls == {"jax": int(train), "torch": int(train)}
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)
    assert tx.shape == (6 * 248, 96) and (tx[~tb.node_mask] == 0).all()
    if train and raw_norm == "BatchNorm":
        new = mut["batch_stats"]["LapPENodeEncoder_0"]["MaskedBatchNorm_0"]
        for ours, theirs in ((enc.lap.raw_norm.running_mean, new["mean"]),
                             (enc.lap.raw_norm.running_var, new["var"])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-5, atol=1e-6)


def _jax_model(jcfg, dim_out, jb):
    from graphgps_tpu.models.networks import build_model as jbuild

    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    return jmodel, randomize_norms(var["params"], var["batch_stats"], seed=9)


def test_voc_model_eval_matches_jax(monkeypatch, loaders):
    """The recipe at 2 layers in evaluation on a full and on a partial
    batch: logits for every real node, labels array for array; the JAX
    layers ran the edge-gate kernel."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.heads import InductiveNodeHead
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    rungs = Rungs(monkeypatch)
    jcfg, _, jl, tcfg, tsplits, tl = loaders
    dim_out = infer_dims(tcfg, tsplits)
    assert dim_out == 5 and tcfg.share.dim_in == 14
    _, jb = next(iter(jl["val"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    model = build_model(tcfg, dim_out).eval()
    assert isinstance(model.head, InductiveNodeHead)
    assert not model.layers[0].holds_front
    load_flax(model, params, stats)
    for split in ("val", "train"):
        _, jb = next(iter(jl[split]))
        _, tb = next(iter(tl[split]))
        rungs.edge_gate = 0
        want, jtrue = jmodel.apply({"params": params, "batch_stats": stats},
                                   jb, False)
        assert rungs.edge_gate == 2 and rungs.core == 0
        with torch.no_grad():
            got, true = model(tb)
        assert got.shape == (6 * 248, 5)
        np.testing.assert_array_equal(true.numpy(), np.asarray(jtrue))
        m = tb.node_mask.numpy()
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def test_voc_two_train_steps_match_jax(monkeypatch):
    """Two whole train steps of the recipe at 2 layers (attention dropout
    0.5 through the port's masks, the same LapPE signs, weighted
    cross-entropy over the real nodes, adamW, clipping) on two batches:
    loss, clipped gradients by the port's parameter names, updated parameters
    and updated running statistics. Updated parameters as in
    ``test_torch_unmerged.py``."""
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_train import _clip

    lr = 1e-3
    rungs = Rungs(monkeypatch)
    calls = _patch_signs(monkeypatch)
    jcfg, _, jl, tcfg, tsplits, tl = voc_loaders(
        "optim.base_lr", str(lr), "optim.scheduler", "none")
    dim_out = infer_dims(tcfg, tsplits)
    jit, tit = iter(jl["train"]), iter(tl["train"])
    jbatches = [next(jit)[1] for _ in range(2)]
    tbatches = [next(tit)[1] for _ in range(2)]
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jbatches[0])
    rungs.edge_gate = 0
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    jstep = jax.jit(raw["train"])
    jgrad = jax.jit(jax.value_and_grad(raw["forward"], has_aux=True))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)

    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(0)

    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                               jnp.asarray(step))
        old = state_dict_from_flax(jax.device_get(state.params))
        state, jloss2, *_ = jstep(state, jb, rng)
        # traced once each: 2 layers' edge gates, attention masks, one flip
        assert rungs.edge_gate == 4 and rungs.core == 0 and rungs.attn == 4
        assert calls["jax"] == 2
        loss, pred, _, mask = train_step(tcfg, model, opt, tb, gen)
        assert calls["torch"] == step + 1
        assert pred.shape == (6 * 248, 5) and torch.equal(mask, tb.node_mask)
        assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                                   atol=ATOL, err_msg=f"loss {step}")

        want_g = _clip({k: v.numpy() for k, v in
                        state_dict_from_flax(jax.device_get(jg)).items()})
        moved = 0.0
        new = {k: v.numpy() for k, v in
               state_dict_from_flax(jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)).items()}
        assert set(want_g) == set(named)
        for k, g in want_g.items():
            got = named[k].grad.numpy()
            np.testing.assert_allclose(
                got, g, rtol=RTOL, atol=ATOL * max(1e-3, np.abs(g).max()),
                err_msg=f"grad {k} step {step}")
            noisy = np.abs(g) < 1e-7
            tol = np.where(noisy, 2 * lr * (step + 1),
                           1e-5 + 1e-5 * np.abs(new[k]) + 1e-2 * lr)
            diff = np.abs(named[k].detach().numpy() - new[k])
            assert (diff <= tol).all(), (k, step, float(diff.max()))
            moved = max(moved, float(np.abs(new[k] - old[k].numpy())[~noisy]
                                     .max(initial=0.0)))
            with torch.no_grad():
                named[k][torch.from_numpy(noisy)] = torch.from_numpy(
                    new[k][noisy])
        assert moved > 0.5 * lr, (step, moved)
        sd = model.state_dict()
        for k in new:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k} {step}")


def test_voc_cli_cpu_trains(tmp_path):
    """Three epochs of the recipe at 2 layers through the entry point on the
    CPU (``ckpt_best``): every stats line holds a finite loss, ``accuracy``
    and ``f1``; the best epoch by val ``f1`` is the one checkpoint left, and
    it reloads into a fresh model that gives that epoch's val ``f1`` again;
    then ``inference-only`` writes one line per split."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.metrics import compute_task_metrics
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint

    small = [*VOC_SMALL, "dataset.synth_max_nodes", "200"]
    opts = [*small, "optim.max_epoch", "3", "optim.num_warmup_epochs", "1",
            "train.ckpt_best", "True", "out_dir", str(tmp_path)]
    _run_cli(VOC_CFG, opts)
    run = tmp_path / "vocsuperpixels-GPS" / "0"
    stats = _stats(run)
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1, 2], split
        assert all(0.0 < r["loss"] < 10.0 for r in rows), split
        assert all(0.0 <= r["f1"] <= 1.0 and "accuracy" in r for r in rows)
    assert stats["train"][0]["loss"] != stats["train"][2]["loss"]
    f1s = [r["f1"] for r in stats["val"]]
    best = max(range(3), key=lambda i: (f1s[i], -i))
    assert checkpoint.saved_epochs(str(run)) == [best]

    cfg = new_cfg()
    load_cfg(cfg, VOC_CFG)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    dim_out = infer_dims(cfg, splits)
    loaders = create_loaders(cfg, splits, "cpu")
    torch.manual_seed(123)
    model = build_model(cfg, dim_out)
    assert checkpoint.load_ckpt(str(run), model) == best + 1
    model.eval()
    preds, trues = [], []
    with torch.no_grad():
        for _real, batch in loaders["val"]:
            pred, true = model(batch)
            preds.append(pred[batch.node_mask].numpy())
            trues.append(true[batch.node_mask].numpy())
    got = compute_task_metrics("classification", np.concatenate(preds),
                               np.concatenate(trues))
    assert got["f1"] == pytest.approx(f1s[best], abs=1e-5)

    out = tmp_path / "eval"
    _run_cli(VOC_CFG, [*small, "train.mode", "inference-only", "out_dir",
                       str(out)])
    for split, rows in _stats(out / "vocsuperpixels-GPS" / "0").items():
        assert len(rows) == 1 and "f1" in rows[0], split
        assert json.dumps(rows[0])   # plain numbers
