"""What the ogbg-molhiv recipe brings to the port beside the layer path,
against the JAX package on the CPU: the binary cross-entropy loss and its
dispatch, the ``classification_binary`` metrics, the ``cosine_with_warmup``
schedule, the synthetic classification dataset (graph for graph) and its
integer labels through the loader; then the entry point on the CPU: the
ogbg-molhiv recipe trains at a tiny size, writes ``auc`` and reloads its
best checkpoint, and ``pcqm4m-GPS+RWSE.yaml`` at a width that is no multiple
of 64 (dropout 0: the plain-tail path in training) trains two epochs."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_data import (MOLHIV_CFG, MOLHIV_SMALL, both_loaders,
                                   small_cfgs)
from tests.test_torch_main import ROOT

torch.set_num_threads(2)

PCQM_GPS_CFG = str(ROOT / "configs/GPS/pcqm4m-GPS+RWSE.yaml")


def _logits_labels(n=64, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    pred = (2.0 * rng.standard_normal((n, 1))).astype(np.float32)
    if ties:
        pred = np.round(pred)
    true = (rng.random(n) < 0.3).astype(np.int32)[:, None]
    mask = rng.random(n) < 0.8
    return pred, true, mask


@pytest.mark.parametrize("size_average", ["mean", "sum"])
def test_binary_cross_entropy_matches_jax(size_average):
    """Loss value (1e-6) and its gradient w.r.t. the logits (1e-6), through
    both packages' ``compute_loss`` on the recipe's ``cross_entropy``."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.models.losses import compute_loss as jloss
    from graphgps_torch.train.loop import compute_loss

    jcfg, tcfg = small_cfgs("model.size_average", size_average,
                            cfg_path=MOLHIV_CFG, small=MOLHIV_SMALL)
    pred, true, mask = _logits_labels()
    want, wgrad = jax.value_and_grad(
        lambda p: jloss(jcfg, p, jnp.asarray(true), jnp.asarray(mask)))(
            jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = compute_loss(tcfg, tp, torch.from_numpy(true),
                       torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-6)


def test_loss_refuses_unported():
    from graphgps_torch.train.loop import compute_loss

    _, tcfg = small_cfgs("dataset.task_type", "classification_multilabel",
                         cfg_path=MOLHIV_CFG, small=MOLHIV_SMALL)
    t = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_loss(tcfg, t, torch.zeros(4, 1), torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("ties", [False, True])
def test_binary_metrics_match_jax(ties):
    """accuracy, accuracy-SBM, precision, recall, f1 and auc (rank
    statistic; average ranks on tied scores), equal to 1e-12; on logits and
    on probabilities; one class absent gives auc 0."""
    from graphgps_tpu.metrics import compute_task_metrics as jm
    from graphgps_torch.metrics import auroc, compute_task_metrics

    pred, true, _ = _logits_labels(200, seed=3, ties=ties)
    for p in (pred, 1.0 / (1.0 + np.exp(-pred))):
        want = jm("classification_binary", p, true)
        got = compute_task_metrics("classification_binary", p, true)
        assert list(got) == ["accuracy", "accuracy-SBM", "precision",
                             "recall", "f1", "auc"]
        for k, v in want.items():
            assert got[k] == pytest.approx(v, abs=1e-12), k
        assert 0.0 < got["auc"] < 1.0
    assert auroc(pred.ravel(), np.zeros(200)) == 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_task_metrics("classification_multilabel", pred, true)


def test_cosine_with_warmup_matches_jax():
    from graphgps_tpu.optim.optimizers import cosine_with_warmup
    from graphgps_torch.optim import build_schedule

    jcfg, tcfg = small_cfgs("optim.max_epoch", "12", cfg_path=MOLHIV_CFG,
                            small=MOLHIV_SMALL)
    assert tcfg.optim.scheduler == "cosine_with_warmup"
    want, got = cosine_with_warmup(jcfg), build_schedule(tcfg)
    lrs = [got(i) for i in range(14)]
    assert lrs == pytest.approx([want(i) for i in range(14)], abs=0, rel=1e-15)
    assert lrs[0] == 0.0 and lrs[5] == pytest.approx(1e-4)
    assert all(a > b for a, b in zip(lrs[5:12], lrs[6:13]))


def test_classification_dataset_matches_jax():
    """The ogbg-molhiv stand-in: the same graphs and the same integer class
    labels as the JAX package's fallback, both classes present."""
    _, jsplits, _, _, tsplits, _ = both_loaders(cfg_path=MOLHIV_CFG,
                                                small=MOLHIV_SMALL)
    labels = []
    for part in ("train", "val", "test"):
        jg, tg = getattr(jsplits, part), getattr(tsplits, part)
        assert len(jg) == len(tg) > 0
        for a, b in zip(jg, tg):
            np.testing.assert_array_equal(a.node_feat, b.node_feat)
            np.testing.assert_array_equal(a.edge_index, b.edge_index)
            np.testing.assert_array_equal(a.edge_feat, b.edge_feat)
            np.testing.assert_array_equal(a.pe["pestat_RWSE"],
                                          b.pe["pestat_RWSE"])
            assert np.issubdtype(b.y.dtype, np.integer)
            np.testing.assert_array_equal(a.y, b.y)
            labels.append(int(b.y[0]))
    assert set(labels) == {0, 1}


@pytest.mark.parametrize("split", ["train", "val"])
def test_classification_loader_matches_jax(split):
    """Integer labels stay integers through the loader; the padded graphs of
    a partial batch keep the label they read, as in the JAX loader."""
    *_, jl, _, _, tl = both_loaders(cfg_path=MOLHIV_CFG, small=MOLHIV_SMALL)
    n = 0
    for (jreal, jb), (treal, tb) in zip(jl[split], tl[split]):
        n += 1
        assert jreal == treal and tb.y.dtype == torch.int32
        for name in ("node_feat", "edge_feat", "senders", "receivers",
                     "node_mask", "edge_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name)
    assert n == len(tl[split]) > 0


def _run_cli(cfg, opts):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graphgps_torch.main", "--device", "cpu",
         "--cfg", cfg, *opts], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _stats(run):
    return {split: [json.loads(line) for line in
                    (run / split / "stats.json").read_text().splitlines()]
            for split in ("train", "val", "test")}


def test_molhiv_cli_cpu_trains(tmp_path):
    """Three epochs of the ogbg-molhiv recipe at 2 layers (dropout 0.05 /
    0.5, BCE, adamW, cosine warm-up over 1 epoch, clipping, ``ckpt_best``):
    every stats line holds a finite loss and ``auc``; the best epoch by val
    ``auc`` (argmax) is the one checkpoint left, and it reloads into a fresh
    model that gives that epoch's val ``auc`` again."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.metrics import compute_task_metrics
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint

    opts = [*MOLHIV_SMALL, "dataset.synth_num_graphs", "80",
            "optim.max_epoch", "3", "optim.num_warmup_epochs", "1",
            "optim.base_lr", "0.001", "train.ckpt_best", "True", "out_dir",
            str(tmp_path)]
    _run_cli(MOLHIV_CFG, opts)
    run = tmp_path / "ogbg-molhiv-GPS+RWSE" / "0"
    stats = _stats(run)
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1, 2], split
        assert all(0.0 < r["loss"] < 5.0 for r in rows), split
        assert all(0.0 <= r["auc"] <= 1.0 and "accuracy" in r for r in rows)
    assert [r["lr"] for r in stats["train"]] == pytest.approx(
        [0.0, 1e-3, 5e-4])
    aucs = [r["auc"] for r in stats["val"]]
    best = max(range(3), key=lambda i: (aucs[i], -i))
    assert checkpoint.saved_epochs(str(run)) == [best]

    cfg = new_cfg()
    load_cfg(cfg, MOLHIV_CFG)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    loaders = create_loaders(cfg, splits, "cpu")
    torch.manual_seed(123)
    model = build_model(cfg, infer_dims(cfg, splits))
    assert checkpoint.load_ckpt(str(run), model) == best + 1
    model.eval()
    preds, trues = [], []
    with torch.no_grad():
        for _real, batch in loaders["val"]:
            pred, true = model(batch)
            preds.append(pred[batch.graph_mask].numpy())
            trues.append(true[batch.graph_mask].numpy())
    got = compute_task_metrics("classification_binary", np.concatenate(preds),
                               np.concatenate(trues))
    assert got["auc"] == pytest.approx(aucs[best], abs=1e-5)


def test_pcqm4m_gps_cli_cpu_trains_plain_tails(tmp_path):
    """``pcqm4m-GPS+RWSE.yaml`` (d = 304, dropout 0, attention dropout 0.5)
    cut to 2 layers at d = 72, a width that is no multiple of 64: training
    takes the standalone core, the plain tails and the plain FFN; two epochs
    write finite ``mae``, and the second epoch's train loss differs from the
    first's (the optimizer moved)."""
    opts = ["gt.layers", "2", "gt.dim_hidden", "72", "gnn.dim_inner", "72",
            "train.batch_size", "8", "dataset.synth_num_graphs", "40",
            "dataset.synth_max_nodes", "14", "optim.max_epoch", "2",
            "optim.num_warmup_epochs", "0", "out_dir", str(tmp_path)]
    _run_cli(PCQM_GPS_CFG, opts)
    stats = _stats(tmp_path / "pcqm4m-GPS+RWSE" / "0")
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1], split
        assert all(0.0 < r["mae"] < 10.0 for r in rows), split
    assert stats["train"][0]["loss"] != stats["train"][1]["loss"]
    assert stats["train"][0]["lr"] == pytest.approx(5e-4)


@pytest.mark.parametrize("key,val,what", [
    ("gt.dim_hidden", "32", "dim_hidden=32"),
    ("dataset.task_type", "classification_multilabel", "task_type"),
    ("optim.scheduler", "step", "scheduler"),
])
def test_molhiv_unported_settings_raise(tmp_path, key, val, what):
    """What the recipe's neighbours still refuse, each naming its ROADMAP
    item: a width below 64, multilabel targets, another schedule."""
    from graphgps_torch.driver import main

    extra = ["gnn.dim_inner", "32"] if key == "gt.dim_hidden" else []
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        main(["--device", "cpu", "--cfg", MOLHIV_CFG, *MOLHIV_SMALL, key, val,
              *extra, "optim.max_epoch", "1", "out_dir", str(tmp_path)])
    assert what in str(err.value)


def test_edge_head_refusal_names_the_edge_head():
    """``pcqm-contact-GPS.yaml`` (``gnn.head inductive_edge``): the stack
    check refuses its head as an edge head for edge and link tasks, citing
    ROADMAP Queue 1 item 17, and not as the default graph head."""
    from graphgps_torch.config import load_cfg, new_cfg
    from graphgps_torch.models.networks import check_stack_supported

    cfg = new_cfg()
    load_cfg(cfg, str(ROOT / "configs/GPS/pcqm-contact-GPS.yaml"))
    assert cfg.gnn.head == "inductive_edge"
    with pytest.raises(NotImplementedError) as err:
        check_stack_supported(cfg)
    msg = str(err.value)
    assert "gnn.head='inductive_edge'" in msg
    assert "an edge head, for edge and link tasks" in msg
    assert "ROADMAP Queue 1 item 17" in msg
    assert "default graph head" not in msg
