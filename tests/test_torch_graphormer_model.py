"""The ZINC Graphormer recipe as a whole against the JAX package on the
CPU: cut to 2 x 64 with 4 heads (the ``fused_ln_ffn`` kernel's path, its
plain version here) in evaluation and for two whole train steps under adamW
and ``polynomial_with_warmup``; the schedule; the node-task Graphormer
recipes' refusal; the entry point, training and evaluating. Dropout masks
and tolerances as in ``test_torch_graphormer.py``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import both_loaders, small_cfgs
from tests.test_torch_graphormer import (ATOL, INPUT_SEED, RTOL, ZINC_CFG,
                                         ZINC_SMALL, Drops, _batches, _boost)
from tests.test_torch_layer import randomize_norms
from tests.test_torch_main import ROOT
from tests.test_torch_tasks import _run_cli, _stats

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def loaders():
    return both_loaders(cfg_path=ZINC_CFG, small=ZINC_SMALL)


def _jax_model(jcfg, jb):
    from graphgps_tpu.models.networks import build_model as jbuild

    jmodel = jbuild(jcfg, 1)
    var = jmodel.init({"params": jax.random.PRNGKey(0),
                       "dropout": jax.random.PRNGKey(0)}, jb, False)
    params = randomize_norms(_boost(var["params"], 10.0), {}, seed=7)[0]
    return jmodel, params


def test_graphormer_model_eval_matches_jax(loaders):
    """The recipe at 2 x 64 (the kernel's path) in evaluation on a full and
    on a half-filled batch: one prediction per real graph, targets array
    for array; every flax leaf lands in the port's state dict."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.graphormer import GraphormerNet
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    jcfg, _, jl, tcfg, tsplits, _ = loaders
    assert infer_dims(tcfg, tsplits) == 1
    jmodel, params = _jax_model(jcfg, _batches(loaders, "val")[0])
    model = build_model(tcfg, 1).eval()
    assert isinstance(model, GraphormerNet)
    load_flax(model, params, {})
    for split in ("val", "train"):
        jb, tb = _batches(loaders, split)
        want, jtrue = jmodel.apply({"params": params}, jb, False)
        with torch.no_grad():
            got, true = model(tb)
        assert got.shape == (8, 1)
        np.testing.assert_array_equal(true.numpy(), np.asarray(jtrue))
        m = tb.graph_mask.numpy()
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def test_graphormer_two_train_steps_match_jax(monkeypatch, loaders):
    """Two whole train steps of the recipe at 2 x 64 (its dropout: 0.1 on
    the input, the attention probabilities and inside the MLP kernel; L1
    over the real graphs; adamW with weight decay 0.01 at the learning rate
    ``polynomial_with_warmup`` gives epoch 3 of 10, warm-up 2) on two
    batches: loss, every gradient by the port's names (the head's LayerNorm,
    which reaches nothing, at 0 on both sides), and the updated parameters
    (the head's LayerNorm decayed alike)."""
    from flax.core import FrozenDict
    from graphgps_tpu.optim.optimizers import make_tx, polynomial_with_warmup
    from graphgps_tpu.optim.optimizers import set_lr as jset_lr
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer, build_schedule, set_lr
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax

    extra = ["optim.max_epoch", "10", "optim.num_warmup_epochs", "2",
             "optim.base_lr", "1e-3"]
    jcfg, _, jl, tcfg, _, tl = both_loaders(*extra, cfg_path=ZINC_CFG,
                                            small=ZINC_SMALL)
    lr = build_schedule(tcfg)(3)
    assert lr == pytest.approx(polynomial_with_warmup(jcfg)(3), abs=0)
    assert 0.0 < lr < 1e-3
    jit, tit = iter(jl["train"]), iter(tl["train"])
    jbatches = [next(jit).to_graph_batch() for _ in range(2)]
    tbatches = [next(tit)[1] for _ in range(2)]
    drops = Drops(monkeypatch, [(INPUT_SEED, 0), (INPUT_SEED, 1)],
                  kernel_width=64)
    jmodel, params = _jax_model(jcfg, jbatches[0])
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    jstep = jax.jit(raw["train"])
    jgrad = jax.jit(jax.value_and_grad(raw["forward"], has_aux=True))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=FrozenDict(),
                       opt_state=jset_lr(tx.init(params), lr),
                       step=jnp.asarray(0))
    rng = run_key(jcfg, 1)

    model = build_model(tcfg, 1).train()
    load_flax(model, params, {})
    opt = build_optimizer(tcfg, model.parameters())
    set_lr(opt, lr)
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(0)
    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                               jnp.asarray(step))
        old = state_dict_from_flax(jax.device_get(state.params))
        state, jloss2, *_ = jstep(state, jb, rng)
        # per trace: the input's two draws; per layer the kernel's seed,
        # the probabilities, and the kernel's site 1 forward and backward
        # (site 2's rate, the recipe's dropout, is 0)
        assert drops.bernoulli == drops.bits == drops.attn > 0
        assert drops.keep.calls == 2 * drops.bits, drops.keep.calls
        loss, pred, _, mask = train_step(tcfg, model, opt, tb, gen)
        assert pred.shape == (8, 1) and torch.equal(mask, tb.graph_mask)
        assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                                   atol=ATOL, err_msg=f"loss {step}")
        want_g = {k: v.numpy() for k, v in
                  state_dict_from_flax(jax.device_get(jg)).items()}
        new = {k: v.numpy() for k, v in
               state_dict_from_flax(jax.device_get(state.params)).items()}
        assert set(want_g) == set(named)
        for k in ("head.norm.weight", "head.norm.bias"):
            assert not want_g[k].any() and not named[k].grad.any()
            # reached by nothing, decayed by adamW alike
            np.testing.assert_allclose(named[k].detach().numpy(), new[k],
                                       rtol=1e-6, atol=0)
            assert not np.array_equal(new[k], old[k].numpy()), k
        moved = 0.0
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


# ---------------------------------------------------------------------------
# schedule, refusals, entry point

def test_polynomial_with_warmup_matches_jax():
    from graphgps_tpu.optim.optimizers import polynomial_with_warmup
    from graphgps_torch.optim import build_schedule

    for extra in ([], ["optim.min_lr", "1e-5", "optim.max_epoch", "20",
                       "optim.num_warmup_epochs", "0"]):
        jcfg, tcfg = small_cfgs(*extra, cfg_path=ZINC_CFG, small=ZINC_SMALL)
        want, got = polynomial_with_warmup(jcfg), build_schedule(tcfg)
        for epoch in range(0, tcfg.optim.max_epoch + 3, 7):
            assert got(epoch) == want(epoch), epoch


@pytest.mark.parametrize("cfg_name", ["actor-Graphormer.yaml",
                                      "wn-chameleon-Graphormer.yaml"])
def test_graphormer_node_recipes_raise(cfg_name):
    """The node-task Graphormer recipes need transductive splits: they
    raise, naming the ROADMAP item."""
    from graphgps_torch.config import load_cfg, new_cfg
    from graphgps_torch.models.networks import build_model

    cfg = new_cfg()
    load_cfg(cfg, str(ROOT / "configs/Graphormer" / cfg_name))
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        build_model(cfg, 5)


def test_graphormer_cli_cpu_trains(tmp_path):
    """Three epochs of the recipe at 2 x 64 through the entry point on the
    CPU (``ckpt_best``): every stats line holds a finite loss and ``mae``;
    the best epoch by val ``mae`` (argmin) is the one checkpoint left, and
    it reloads into a fresh model that gives that epoch's val ``mae`` again;
    then ``inference-only`` writes one line per split."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.metrics import compute_task_metrics
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint

    opts = [*ZINC_SMALL, "optim.max_epoch", "3", "optim.num_warmup_epochs",
            "1", "train.ckpt_best", "True", "out_dir", str(tmp_path)]
    _run_cli(ZINC_CFG, opts)
    run = tmp_path / "zinc-Graphormer" / "0"
    stats = _stats(run)
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1, 2], split
        assert all(0.0 < r["mae"] < 10.0 for r in rows), split
    maes = [r["mae"] for r in stats["val"]]
    best = min(range(3), key=lambda i: (maes[i], i))
    assert checkpoint.saved_epochs(str(run)) == [best]

    cfg = new_cfg()
    load_cfg(cfg, ZINC_CFG)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    loaders = create_loaders(cfg, splits, "cpu")
    model = build_model(cfg, infer_dims(cfg, splits))
    assert checkpoint.load_ckpt(str(run), model) == best + 1
    model.eval()
    preds, trues = [], []
    with torch.no_grad():
        for _real, batch in loaders["val"]:
            pred, true = model(batch)
            preds.append(pred[batch.graph_mask].numpy())
            trues.append(true[batch.graph_mask].numpy())
    got = compute_task_metrics("regression", np.concatenate(preds),
                               np.concatenate(trues))
    assert got["mae"] == pytest.approx(maes[best], abs=1e-5)

    out = tmp_path / "eval"
    _run_cli(ZINC_CFG, [*ZINC_SMALL, "train.mode", "inference-only",
                        "out_dir", str(out)])
    for split, rows in _stats(out / "zinc-Graphormer" / "0").items():
        assert len(rows) == 1 and "mae" in rows[0], split
        assert json.dumps(rows[0])   # plain numbers
