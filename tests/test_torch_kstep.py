"""K training steps per dispatch (``train.steps_per_dispatch``) and the
dropout seeds in device memory that it rests on.

On the CPU (the kernels' plain versions; JAX imported inside the tests):

- the port's K-step epoch (``KSteps`` over ``epoch_groups``' index table, K
  = 3 over a train split of 4 batches, so the last group holds one real
  batch and two fillers) against the JAX package's ``make_scan_steps`` on
  the same weights and index table at dropout 0, for a 2-layer GPS-deep at
  d = 128 on the merged path (``GGPS_FUSED_FRONT=1``), a 2-layer
  ogbg-molhiv at d = 64 and a 2-layer zinc-GPS+RWSE (GINE) at d = 64, from
  random weights with running statistics
  calibrated on the split (``_calibrated_stats``): per-step losses and
  loss masks, parameters, running statistics, Adam's moments and step
  counts, at the train-step tests' tolerances (rtol = atol = 1e-4; a
  moment's atol 1e-4 of its tensor's largest entry; a parameter whose
  gradient is zero in exact arithmetic, a bias that a BatchNorm removes,
  moves by up to 2·lr a step on f32 noise in either package, as in
  ``test_torch_unmerged.py``), at lr 1e-4 (``SCAN_LR``); at most
  ``SMALL_STEP_ENTRIES`` other parameter entries may part by up to 2·lr a
  step (Adam's first step of a small gradient), and the test prints them;
- with dropout on, a K-step epoch equals the eager epoch of the same
  generator in every bit;
- a group with filler batches leaves the state as its real steps alone;
- the eligibility rule equals JAX's loader decision, with JAX's warning;
- each seeded kernel's plain version and the torch-op hash give the same
  bits for an int seed and for the same seed in a 0-d int32 tensor;
- a run stopped after epoch 1 and resumed trains its epoch over the
  train split's shuffle of epoch 0, K-step and eager, as JAX's loop does
  (its loader's epoch counter starts at 0 and a resume leaves it there).

On the card (``cuda`` marker, no JAX; ``python -m pytest --noconftest -o
addopts= -m cuda tests/test_torch_kstep.py``): every kernel that reads its
dropout seed from device memory, captured once in a CUDA graph and
replayed with two seeds written into its seed buffer, gives its eager
calls' bits with those seeds, forward and backward; and a 2-layer d = 128
model's captured training step gives its eager step's loss, parameters,
running statistics and Adam state.
"""
import copy
import json
import logging
import pathlib

import numpy as np
import pytest
import torch

try:
    from tests.test_torch_data import (CFG, MOLHIV_CFG, MOLHIV_SMALL, SMALL,
                                       small_cfgs)
except ImportError:     # the card's run (no conftest): siblings by name
    from test_torch_data import (CFG, MOLHIV_CFG, MOLHIV_SMALL, SMALL,
                                 small_cfgs)

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
LR = 1e-3
# the learning rate of the comparison with JAX's scan. Adam turns the f32
# noise of a gradient that is zero in exact arithmetic into a step of up to
# 2·lr, and where a BatchNorm removes that bias only in part (the GatedGCN's
# B on nodes without edges) it reaches the next step's forward: at lr 1e-3
# a step-2 prediction of either recipe moves by 5e-4 to 7e-4. The two-step
# tests set those entries to JAX's values between the steps; inside a group
# of K steps nothing can, so the scan runs at a tenth of the rate.
SCAN_LR = 1e-4
# Adam's first step moves an entry by lr·sign(g) whatever |g|: where an
# entry's first gradient is small beside its later ones, the f32 error of
# that gradient (1e-4 of its tensor's scale) changes the entry's whole move
# by up to 2·lr a step. One entry of each recipe does (the RWSE input norm's
# scale, 3e-5 against a tolerance of 2.5e-5 after 4 steps); a wrong update
# rule, rate, step count or batch would move most entries
SMALL_STEP_ENTRIES = 2
K = 3
# zinc-GPS+RWSE (GINE, TypeDictNode+RWSE, TypeDictEdge) and its LapPE
# neighbour cut to 2 layers on 40 graphs: train 32 (4 batches of 8)
ZINC_CFG = str(pathlib.Path(CFG).with_name("zinc-GPS+RWSE.yaml"))
ZINC_LAPPE_CFG = str(pathlib.Path(CFG).with_name("zinc-GPS.yaml"))
ZINC_SMALL = ["gt.layers", "2", "train.batch_size", "8",
              "dataset.synth_num_graphs", "40"]
RECIPES = {"pcqm4m-GPSdeep": dict(cfg_path=CFG, small=SMALL),
           "ogbg-molhiv": dict(cfg_path=MOLHIV_CFG, small=MOLHIV_SMALL),
           "zinc-GPS+RWSE": dict(cfg_path=ZINC_CFG, small=ZINC_SMALL)}


def _port_run(recipe, *extra, device="cpu"):
    """(cfg, splits, loaders, seeded model in training mode) of a recipe
    cut to test size, the port alone."""
    from graphgps_torch import config as tc
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model

    which = RECIPES[recipe]
    cfg = tc.new_cfg()
    tc.load_cfg(cfg, which["cfg_path"])
    tc.update_from_list(cfg, list(which["small"]) + [
        "train.mode", "custom", "train.steps_per_dispatch", str(K),
        *extra])
    splits = load_dataset(cfg)
    loaders = create_loaders(cfg, splits, device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = build_model(cfg, infer_dims(cfg, splits))
    return cfg, splits, loaders, model.to(device).train()


def _opt_state(opt, model):
    """Adam's (exp_avg, exp_avg_sq, step) by parameter name."""
    return {name: tuple(opt.state[p][k] for k in ("exp_avg", "exp_avg_sq",
                                                  "step"))
            for name, p in model.named_parameters()}


def _equal_states(m1, o1, m2, o2):
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = _opt_state(o1, m1), _opt_state(o2, m2)
    for k in s1:
        for a, b in zip(s1[k], s2[k]):
            assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# against the JAX package

def _adam(opt_state, params):
    """(mu, nu, count) of the JAX optimizer state, mu and nu as param
    trees."""
    import jax
    import optax
    from jax.flatten_util import ravel_pytree

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    mu, nu, count = found[0].mu, found[0].nu, found[0].count
    if not isinstance(mu, dict):     # the flat optimizer's raveled moments
        unravel = ravel_pytree(params)[1]
        mu, nu = unravel(mu), unravel(nu)
    return jax.device_get(mu), jax.device_get(nu), int(count)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_k_step_epoch_matches_jax_scan(monkeypatch, recipe):
    """One epoch K = 3 steps per dispatch: the port's ``KSteps`` against
    JAX's ``make_scan_steps`` group by group on one index table."""
    import jax
    import jax.numpy as jnp

    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, make_scan_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import KSteps, epoch_groups
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_data import both_loaders
    from tests.test_torch_layer import randomize_norms

    monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
    jcfg, _, jloaders, tcfg, tsplits, tloaders = both_loaders(
        "gt.dropout", "0.0", "gt.attn_dropout", "0.0", "optim.base_lr",
        str(SCAN_LR), "train.mode", "custom", "train.steps_per_dispatch", str(K),
        **RECIPES[recipe])
    dim_out = infer_dims(tcfg, tsplits)
    loader = tloaders["train"]
    sel, reals = epoch_groups(loader, K)
    assert sel.shape[0] == 2 and list(reals[-1][1:]) == [0, 0]

    jmodel = jbuild(jcfg, dim_out)
    _, jb = next(iter(jloaders["val"]))
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=9)
    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    stats = _calibrated_stats(model, loader, sel, params, stats)
    tx = make_tx(jcfg)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    multi = make_scan_steps(jcfg, jmodel, tx, jloaders["train"])
    rng = run_key(jcfg, 1)

    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    k_steps = KSteps(tcfg, model, opt, loader, torch.Generator())
    steps = 0
    for gi in range(sel.shape[0]):
        rows = k_steps(sel[gi], reals[gi])
        state, losses, _, _, masks = multi(
            state, sel[gi].astype(np.int32), jax.random.fold_in(rng, gi))
        real = [k for k in range(K) if reals[gi][k] > 0]
        assert len(rows) == len(real)
        for (loss, _, _, mask, n), k in zip(rows, real):
            assert n == reals[gi][k]
            np.testing.assert_allclose(float(loss), float(losses[k]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(masks[k]))
            steps += 1
    assert int(state.step) == steps == 4

    jparams = jax.device_get(state.params)
    new = {k: v.numpy() for k, v in state_dict_from_flax(
        jparams, jax.device_get(state.batch_stats)).items()}
    mu, nu, count = _adam(state.opt_state, jparams)
    assert count == steps
    mu, nu = state_dict_from_flax(mu), state_dict_from_flax(nu)
    named = dict(model.named_parameters())
    sd = model.state_dict()
    start = state_dict_from_flax(params)
    # the scale of a moment: its largest entry, floored at 1e-2 of the
    # largest of that moment over the model, as chip_smoke.py 4c floors a
    # gradient's (a bias a BatchNorm removes has moments of f32 noise)
    top = [max(float(np.abs(m[n].numpy()).max()) for n in mu)
           for m in (mu, nu)]
    small_steps = []
    moved = 0.0   # the epoch did something: the largest clean move
    for name in mu:
        st = opt.state[named[name]]
        assert int(st["step"]) == steps, name
        for key, want, big in (("exp_avg", mu[name], top[0]),
                               ("exp_avg_sq", nu[name], top[1])):
            want = want.numpy()
            scale = max(float(np.abs(want).max()), 1e-2 * big)
            np.testing.assert_allclose(st[key].numpy(), want, rtol=RTOL,
                                       atol=ATOL * scale,
                                       err_msg=f"{key} of {name}")
        # a gradient zero in exact arithmetic: Adam's step of f32 noise
        v_hat = nu[name].numpy() / (1.0 - 0.999 ** steps)
        noisy = np.sqrt(v_hat) < 1e-7
        tol = np.where(noisy, 2 * SCAN_LR * steps,
                       1e-5 + 1e-5 * np.abs(new[name])
                       + 1e-2 * SCAN_LR * steps)
        diff = np.abs(named[name].detach().numpy() - new[name])
        assert (diff <= 2 * SCAN_LR * steps).all(), (name, diff.max())
        small_steps += [(name, int(i), float(diff.flat[i]), float(tol.flat[i]))
                        for i in np.flatnonzero(diff > tol)]
        moved = max(moved, float(np.where(
            noisy, 0.0, np.abs(new[name] - start[name].numpy())).max()))
    assert moved > 0.5 * SCAN_LR * steps, moved
    print(json.dumps(dict(recipe=recipe, small_step_entries=small_steps)))
    assert len(small_steps) <= SMALL_STEP_ENTRIES, small_steps
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)

def _calibrated_stats(model, loader, sel, params, stats):
    """``stats`` (flax ``batch_stats``) with every running statistic set to
    what training over the split's batches leaves it at (momentum 0.5, 8
    passes over the real batches of ``sel``): the shift of the single-pass
    variance (``MaskedBatchNorm.batch_stats``) then lies near the batch
    mean, as in training. The random means of ``randomize_norms`` lie far
    from it and cancel catastrophically in f32: an RWSE column that is 0 on
    every node (no graph has a self-loop) gets a variance of f32 noise."""
    import jax

    from graphgps_torch.models.common import MaskedBatchNorm
    from graphgps_torch.weights import state_dict_from_flax

    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    moms = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 0.5
    rows = [torch.as_tensor(r) for r in sel.reshape(-1, sel.shape[-1])
            if (r >= 0).any()]
    with torch.no_grad():
        for _ in range(8):
            for r in rows:
                model(loader.arenas.assemble(r, loader.max_nodes))
    for m, mo in zip(norms, moms):
        m.momentum = mo
    # each flax leaf's entries numbered, to find where the port keeps them
    leaves, tree = jax.tree_util.tree_flatten(stats)
    ids = [1000 * i + np.arange(leaf.size).reshape(leaf.shape)
           for i, leaf in enumerate(leaves)]
    assert all(leaf.size < 1000 for leaf in leaves)
    where = state_dict_from_flax(params, tree.unflatten(ids))
    sd = model.state_dict()
    out = [np.array(leaf, np.float32) for leaf in leaves]
    found = 0
    for k, v in where.items():
        if k.endswith(("running_mean", "running_var")):
            v = v.numpy().astype(np.int64).reshape(-1)
            for j, n in enumerate(v):
                out[n // 1000].reshape(-1)[n % 1000] = float(
                    sd[k].reshape(-1)[j])
            found += v.size
    assert found == sum(leaf.size for leaf in leaves)
    return tree.unflatten(out)


@pytest.mark.parametrize("recipe", ["pcqm4m-GPSdeep", "ogbg-molhiv", "VOC",
                                    "ogbg-molhiv-SAN", "zinc-GPS+RWSE",
                                    "zinc-GPS"])
def test_eligibility_matches_jax(recipe, caplog):
    """``k_steps_eligible`` takes K steps exactly where the JAX driver builds
    a ``DeviceLoader`` for the train split (and so runs ``make_scan_steps``),
    and logs JAX's warning where it falls back."""
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.data.device_loader import DeviceLoader
    from graphgps_tpu.driver import create_loaders as jcreate
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.train.loop import k_steps_eligible
    from tests.test_torch_san import SAN_CFG, SAN_SMALL
    from tests.test_torch_voc import VOC_CFG, VOC_SMALL

    which = dict(RECIPES, VOC=dict(cfg_path=VOC_CFG, small=VOC_SMALL))
    which["ogbg-molhiv-SAN"] = dict(cfg_path=SAN_CFG, small=SAN_SMALL)
    which["zinc-GPS"] = dict(cfg_path=ZINC_LAPPE_CFG, small=ZINC_SMALL)
    jcfg, tcfg = small_cfgs("train.steps_per_dispatch", "4", **which[recipe])
    jsplits = jload(jcfg)
    jax_k = isinstance(jcreate(jcfg, jsplits)["train"], DeviceLoader)
    tsplits = load_dataset(tcfg)
    with caplog.at_level(logging.WARNING, logger="graphgps_torch"):
        port_k = k_steps_eligible(tcfg, set(tsplits.train[0].extras))
    assert port_k == jax_k == (recipe in RECIPES)
    warned = [r for r in caplog.records
              if "steps_per_dispatch>1 needs a DeviceLoader" in r.message]
    assert len(warned) == (0 if jax_k else 1)
    # the recipe's own setting: one step per dispatch, but zinc-GPS+RWSE's
    # published K = 32
    own = small_cfgs(**which[recipe])[1]
    assert k_steps_eligible(own, set()) == (recipe == "zinc-GPS+RWSE")


# ---------------------------------------------------------------------------
# the port against itself

@pytest.mark.parametrize("recipe", list(RECIPES))
def test_k_step_epochs_equal_eager_epochs(monkeypatch, tmp_path, recipe):
    """Two epochs at the recipe's dropout (GPS-deep 0.1 / 0.1 on the merged
    path, ogbg-molhiv 0.05 / 0.5 and zinc-GPS+RWSE 0 / 0.5 with the torch-op
    attention mask), K = 3:
    the same stats lines, parameters, running statistics, Adam state and
    generator state as two eager epochs from the same generator seed."""
    from graphgps_torch.logging_utils import SplitLogger
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import KSteps, train_epoch, train_epoch_k

    monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
    out = []
    for k_path in (True, False):
        cfg, _, loaders, model = _port_run(recipe)
        assert max(cfg.gt.dropout, cfg.gt.attn_dropout) > 0
        opt = build_optimizer(cfg, model.parameters())
        gen = torch.Generator().manual_seed(11)
        logger = SplitLogger("train", str(tmp_path / str(k_path)),
                             cfg.dataset.task_type)
        k_steps = KSteps(cfg, model, opt, loaders["train"], gen)
        rows = []
        for epoch in range(2):
            if k_path:
                train_epoch_k(cfg, model, k_steps, loaders["train"], logger,
                              LR)
            else:
                train_epoch(cfg, model, opt, loaders["train"], logger, LR,
                            gen)
            row = logger.write_epoch(epoch)
            rows.append({k: v for k, v in row.items()
                         if not k.startswith("time")})
        out.append((rows, model, opt, gen.get_state()))
    (rk, mk, ok, gk), (re, me, oe, ge) = out
    assert rk == re
    assert torch.equal(gk, ge)
    _equal_states(mk, ok, me, oe)


def test_filler_batches_leave_the_state(monkeypatch):
    """A group of one real batch and two all-(−1) fillers leaves the
    parameters, running statistics, Adam state (step count included) and
    the generator as the real batch's step alone leaves them."""
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import KSteps, train_step

    monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
    cfg, _, loaders, model = _port_run("pcqm4m-GPSdeep")
    loader = loaders["train"]
    other = copy.deepcopy(model)
    B = loader.batch_size
    sel = -np.ones((K, B), np.int64)
    sel[0] = np.arange(B)
    reals = (sel >= 0).sum(1)

    opt = build_optimizer(cfg, model.parameters())
    gen = torch.Generator().manual_seed(3)
    rows = KSteps(cfg, model, opt, loader, gen)(sel, reals)
    assert len(rows) == 1 and rows[0][-1] == B

    opt2 = build_optimizer(cfg, other.parameters())
    gen2 = torch.Generator().manual_seed(3)
    batch = loader.arenas.assemble(torch.as_tensor(sel[0]), loader.max_nodes)
    loss = train_step(cfg, other, opt2, batch, gen2)[0]
    assert torch.equal(rows[0][0], loss)
    assert torch.equal(gen.get_state(), gen2.get_state())
    _equal_states(model, opt, other, opt2)
    assert int(opt.state[next(model.parameters())]["step"]) == 1


def _resumed_run_ends_where_an_uninterrupted_one_ends(tmp_path, k: int):
    """A 3-epoch run at ``train.steps_per_dispatch`` k keeps a checkpoint
    per epoch; with epoch 2's removed (a run stopped after epoch 1), a run
    with ``train.auto_resume`` trains epoch 2 again from epoch 1's
    checkpoint (model, Adam state, generator) over the train split's
    shuffle of epoch 0, as the JAX package's loop does: its
    ``DeviceLoader`` starts at epoch 0, ``custom_train`` leaves the counter
    alone, and both its epoch forms (``__iter__``, ``train_epoch_scan``)
    shuffle with ``default_rng(seed + epoch)``. The resumed run saves the
    state of epoch 1's checkpoint plus one epoch over epoch 0's order,
    computed here batch by batch with ``train_step``; the uninterrupted
    run's epoch 2 (over epoch 2's order) ends elsewhere."""
    from graphgps_torch import config as tc
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims, main
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer, build_schedule, set_lr
    from graphgps_torch.train import checkpoint
    from graphgps_torch.train.loop import train_step
    from tests.test_torch_data import both_loaders

    opts = [*SMALL, "train.mode", "custom", "train.steps_per_dispatch",
            str(k), "train.ckpt_best", "False", "train.ckpt_period", "1",
            "optim.max_epoch", "3", "optim.num_warmup_epochs", "1",
            "out_dir", str(tmp_path)]
    base = ["--device", "cpu", "--cfg", CFG, *opts]
    main(base)
    run_dir = tmp_path / "pcqm4m-GPSdeep+RWSE" / "0"
    ckpt = run_dir / "ckpt"
    whole = torch.load(ckpt / "2.pt", weights_only=True)
    (ckpt / "2.pt").unlink()
    second = main(base + ["train.auto_resume", "True"])[0]
    assert [r["epoch"] for r in second["train"]] == [2]
    resumed = torch.load(ckpt / "2.pt", weights_only=True)

    # epoch 1's checkpoint plus one epoch over epoch 0's order
    cfg = tc.new_cfg()
    tc.load_cfg(cfg, CFG)
    tc.update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    loader = create_loaders(cfg, splits, "cpu")["train"]
    model = build_model(cfg, infer_dims(cfg, splits))
    opt = build_optimizer(cfg, model.parameters())
    gen = torch.Generator()
    assert checkpoint.load_ckpt(str(run_dir), model, opt, 1, gen) == 2
    set_lr(opt, build_schedule(cfg)(2))
    model.train()
    n, B = loader.arenas.num_graphs_total, loader.batch_size
    order = np.arange(n)
    np.random.default_rng(cfg.seed + 0).shuffle(order)
    later = np.arange(n)
    np.random.default_rng(cfg.seed + 2).shuffle(later)
    assert not np.array_equal(order, later)
    chunks = [np.concatenate([order[s:s + B],
                              -np.ones(max(0, s + B - n), np.int64)])
              for s in range(0, n, B)]
    batches = [loader.arenas.assemble(torch.as_tensor(c), loader.max_nodes)
               for c in chunks]
    for batch in batches:
        train_step(cfg, model, opt, batch, gen)
    for key, v in model.state_dict().items():
        assert torch.equal(v, resumed["model"][key]), key
    assert torch.equal(gen.get_state(), resumed["generator"])
    for i, st in opt.state_dict()["state"].items():
        for key, v in st.items():
            assert torch.equal(v, resumed["optimizer"]["state"][i][key]), \
                (i, key)
    assert any(not torch.equal(v, resumed["model"][key])
               for key, v in whole["model"].items())

    # the JAX side of the rule: a new train DeviceLoader at epoch 0 gives
    # the graphs of that order
    from graphgps_tpu.data.device_loader import DeviceLoader

    jloader = both_loaders(*opts[len(SMALL):])[2]["train"]
    assert isinstance(jloader, DeviceLoader) and jloader.epoch == 0
    assert jloader.seed == cfg.seed
    got = [(real, jb) for real, jb in jloader]
    assert len(got) == len(batches)
    for (real, jb), batch in zip(got, batches):
        np.testing.assert_array_equal(np.asarray(jb.y)[:real],
                                      batch.y[:real].numpy())


def test_resumed_k_step_run_ends_where_an_uninterrupted_one_ends(tmp_path):
    """``train.auto_resume`` with K = 3 (:func:`_resumed_run_ends_where_an_
    uninterrupted_one_ends`): the resumed epoch's groups come from epoch 0's
    order, as JAX's ``train_epoch_scan`` takes them on a new loader."""
    _resumed_run_ends_where_an_uninterrupted_one_ends(tmp_path, K)


def test_resumed_eager_run_ends_where_an_uninterrupted_one_ends(tmp_path):
    """``train.auto_resume`` with one step per dispatch: the resumed epoch
    takes epoch 0's order, as a new JAX ``DeviceLoader``'s first
    iteration does (:func:`_resumed_run_ends_where_an_uninterrupted_one_ends`)."""
    _resumed_run_ends_where_an_uninterrupted_one_ends(tmp_path, 1)


# ---------------------------------------------------------------------------
# seeds as ints and as tensors

def seeded_cases(device, seed: int = 0):
    """{name: (wrapper, inputs before the seed, arguments after it, indices
    of the differentiable inputs)} for every kernel wrapper that drops, at
    small shapes the kernels take, dropout on every site."""
    from graphgps_torch.ops import kernels
    try:
        from tests.test_torch_kernels import _ORDER, front_inputs
    except ImportError:     # the card's run (no conftest)
        from test_torch_kernels import _ORDER, front_inputs

    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g).to(device)  # noqa: E731
    inv = lambda d: (0.5 + torch.rand(d, generator=g)).to(device)  # noqa
    R, d, dh = 96, 64, 128
    a = front_inputs(B=4, N=16, E=32, d=128, H=4, seed=seed)
    front = tuple(torch.from_numpy(a[k]).to(device) for k in _ORDER)
    B, N, da, H = 4, 24, 128, 4
    kmask = (torch.arange(N)[None, :] < torch.tensor([24, 20, 9, 1])[:, None]
             ).float().to(device)
    att = (f(B, N, da), kmask, f(da, 3 * da) / 11, f(3 * da), f(da, da) / 11,
           f(da))
    wide = (f(B, 136, da), torch.tensor([136, 130, 40, 1], dtype=torch.int32,
                                        device=device), *att[2:])
    ffn = (f(d, dh) / 8, f(dh), f(dh, d) / 11, f(d))
    return {
        "drop_add": (kernels.fused_drop_add, (f(R, d), f(R, d)), (0.25,),
                     (0, 1)),
        "pre_tail": (kernels.fused_pre_tail,
                     (f(R, d), f(R, d), f(d), inv(d), f(d), f(d)),
                     (0.25, "relu"), range(6)),
        "combine_ffn": (kernels.fused_combine_ffn,
                        (f(R, d), f(R, d), f(d), inv(d), f(d), f(d), f(R, d),
                         f(d), inv(d), f(d), f(d), *ffn), (0.25, "gelu"),
                        range(15)),
        "gps_front": (kernels.fused_gps_front, front,
                      (a["H"], a["scale"], 0.25, 0.25),
                      (0, 1, 9, 10, 11, 12, 13, 14)),
        "gps_attention": (kernels.fused_gps_attention, att, (H, 0.25),
                          (0, 2, 3, 4, 5)),
        "wide_attention": (kernels.fused_wide_attention, wide,
                           (H, 1.0 / (da // H) ** 0.5, 0.25),
                           (0, 2, 3, 4, 5)),
        "ffn": (kernels.fused_ffn, (f(R, d), *ffn), (0.25, "gelu"),
                range(5)),
        "bn_ffn": (kernels.fused_bn_ffn,
                   (f(R, d), f(d), inv(d), f(d), f(d), *ffn),
                   (0.25, "relu", True), range(9)),
        "ln_ffn": (kernels.fused_ln_ffn,
                   (f(R, d), 1.0 + 0.1 * f(d), f(d), *ffn),
                   (0.25, 0.25, "gelu"), range(7)),
    }


def run_case(case, seed, cots=None):
    """The wrapper's outputs and the gradients of its differentiable inputs
    under the cotangents ``cots`` (by default seeded ones, made on the host;
    a capture takes them made beforehand)."""
    fn, ins, after, diff = case
    ins = [t.detach().clone().requires_grad_() if i in diff else t
           for i, t in enumerate(ins)]
    outs = fn(*ins, seed, *after)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if cots is None:
        g = torch.Generator().manual_seed(1)
        cots = [torch.randn(o.shape, generator=g).to(o.device) for o in outs]
    grads = torch.autograd.grad(outs, [ins[i] for i in diff], cots)
    return [o.detach() for o in outs] + list(grads)


SEEDED = ["drop_add", "pre_tail", "combine_ffn", "gps_front",
          "gps_attention", "wide_attention", "ffn", "bn_ffn", "ln_ffn"]


@pytest.mark.parametrize("name", SEEDED)
def test_plain_versions_take_tensor_seeds(name):
    """A kernel's plain version (the wrapper on CPU tensors), forward and
    backward, gives the same bits for an int seed and for it in a 0-d int32
    tensor; another seed gives other outputs."""
    case = seeded_cases("cpu")[name]
    for seed in (7, 2 ** 31 - 3):
        want = run_case(case, seed)
        got = run_case(case, torch.tensor(seed, dtype=torch.int32))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    other = run_case(case, torch.tensor(8, dtype=torch.int32))
    assert not all(torch.equal(a, b)
                   for a, b in zip(other, run_case(case, 7)))


def test_torch_op_hash_takes_tensor_seeds():
    """``drop_key``, ``drop_bits``, ``dropout_mask`` (over a block of a wider
    view), ``apply_dropout`` and ``exact_dropout``: the same values for an
    int seed and for a 0-d int32 tensor holding its 32 bits (a seed of
    2^31 or more as its negative int32)."""
    from graphgps_torch.ops.kernels.common import (apply_dropout, drop_bits,
                                                   drop_key, dropout_mask,
                                                   exact_dropout)

    v = torch.randn(33, 20, generator=torch.Generator().manual_seed(0))
    for seed in (0, 5, 2 ** 31 - 1, 3_000_000_000):
        t = torch.tensor(seed - (seed >> 31 << 32), dtype=torch.int32)
        assert int(drop_key(t, 3)) == drop_key(seed, 3)
        assert torch.equal(drop_bits(t, 2, 7, 9, row0=4, col0=5, width=40),
                           drop_bits(seed, 2, 7, 9, row0=4, col0=5, width=40))
        assert torch.equal(dropout_mask(t, 1, 33, 20, 0.3, col0=20,
                                        width=60),
                           dropout_mask(seed, 1, 33, 20, 0.3, col0=20,
                                        width=60))
        assert torch.equal(apply_dropout(v, t, 0, 0.5),
                           apply_dropout(v, seed, 0, 0.5))
        assert torch.equal(exact_dropout(v, t, 1, 0.1),
                           exact_dropout(v, seed, 1, 0.1))


def test_step_seeds_draw_as_the_modules_did():
    """``StepSeeds`` on a generator draws, take by take, the seeds that one
    draw of all of them gives (what the K-step path draws for a group), as
    0-d int32 tensors; drawn ahead (``expect``: as many as the takes, more,
    fewer, or with a draw on the host between takes) it hands out the same
    seeds and leaves the generator where draws take by take leave it; each
    carries its value for the torch-op hash (``host_value``). A fixed table
    hands out views of itself and refuses to run dry; a host generator
    hands out the same seeds on the host."""
    from graphgps_torch.models.gps_layer import StepSeeds, draw_seeds
    from graphgps_torch.ops.kernels.common import drop_key
    from graphgps_torch.train.loop import _draw_table

    def run(expect, host_at=None):
        gen = torch.Generator().manual_seed(4)
        seeds = StepSeeds(gen, "cpu", expect=expect)
        takes, signs = [], None
        for i, n in enumerate((3, 4, 3)):
            if i == host_at:
                signs = torch.rand(2, generator=seeds.host_generator())
            takes += draw_seeds(seeds, n)
        seeds.settle()
        assert seeds.used == 10
        assert all(t.dtype == torch.int32 and t.dim() == 0 for t in takes)
        assert [t.host_value for t in takes] == [int(t) for t in takes]
        return torch.stack(takes), signs, gen.get_state()

    want, _, state = run(0)
    again = _draw_table(torch.Generator().manual_seed(4), 2, 5)
    assert torch.equal(want, again.reshape(-1))
    assert drop_key(want[0], 2) == drop_key(int(want[0]), 2)
    assert drop_key(want[0].clone(), 2) == drop_key(int(want[0]), 2)
    for expect in (10, 12, 6):
        got, _, got_state = run(expect)
        assert torch.equal(got, want) and torch.equal(got_state, state)
    want_h, signs, state_h = run(0, host_at=1)
    for expect in (0, 10):
        got, got_signs, got_state = run(expect, host_at=1)
        assert torch.equal(got, want_h) and torch.equal(got_signs, signs)
        assert torch.equal(got_state, state_h)
    assert torch.equal(torch.stack(draw_seeds(
        torch.Generator().manual_seed(4), 3)), want[:3])
    table = torch.arange(5, dtype=torch.int32)
    fixed = StepSeeds(table=table)
    views = draw_seeds(fixed, 4)
    assert [v.data_ptr() for v in views] == [table[i].data_ptr()
                                             for i in range(4)]
    with pytest.raises(RuntimeError, match="more than"):
        draw_seeds(fixed, 2)
    with pytest.raises(RuntimeError, match="draws nothing"):
        fixed.host_generator()


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEEDED)
def test_cuda_captured_kernel_replays_its_seed(cuda_device, name):
    """On the card: the kernel's forward and backward with the seed an
    element of a device seed buffer, captured once in a CUDA graph; two
    replays with two seeds written into the buffer each give the eager
    calls' bits with that seed, and the two differ."""
    case = seeded_cases(cuda_device)[name]
    buf = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    seeds = (12345, 2 ** 31 - 77)
    want = []
    for s in seeds:
        buf[1] = s
        want.append(run_case(case, buf[1]))
    g = torch.Generator().manual_seed(1)
    n_out = len(want[0]) - len(case[3])
    cots = [torch.randn(o.shape, generator=g).to(cuda_device)
            for o in want[0][:n_out]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_case(case, buf[1], cots)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run_case(case, buf[1], cots)
    for s, w in zip(seeds, want):
        buf[1] = s
        graph.replay()
        torch.cuda.synchronize()
        for c, e in zip(captured, w):
            assert torch.equal(c, e)
    assert not all(torch.equal(a, b) for a, b in zip(*want))


@pytest.mark.cuda
def test_cuda_captured_train_step_equals_eager(cuda_device):
    """On the card: a 2-layer d = 128 GPS-deep (merged path, dropout 0.1 /
    0.1) trained K = 3 steps per dispatch over one epoch of 8 batches of 4
    graphs (2 eager warm-up steps, then 6 replays of the captured step; the
    last group ends in a filler) against eager steps with the same
    generator: per-step losses, parameters, running statistics and Adam
    state (capturable on both sides), bit for bit."""
    from graphgps_torch.ops import kernels
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import (KSteps, _step, epoch_groups)
    from graphgps_torch.models.gps_layer import StepSeeds

    cfg, _, loaders, model = _port_run("pcqm4m-GPSdeep", "train.batch_size",
                                       "4", device=cuda_device)
    loader = loaders["train"]
    other = copy.deepcopy(model)
    sel, reals = epoch_groups(loader, K)
    opt = build_optimizer(cfg, model.parameters(), capturable=True)
    k_steps = KSteps(cfg, model, opt, loader, torch.Generator().manual_seed(2))
    kernels.reset_launch_counts()
    got = [r for gi in range(sel.shape[0]) for r in k_steps(sel[gi],
                                                            reals[gi])]
    assert kernels.graph_replays() == len(got) - 2 > 0

    opt2 = build_optimizer(cfg, other.parameters(), capturable=True)
    gen = torch.Generator().manual_seed(2)
    for (loss, *_), row in zip(got, sel.reshape(-1, sel.shape[-1])):
        batch = loader.arenas.assemble(torch.as_tensor(row, device=cuda_device),
                                       loader.max_nodes)
        opt2.zero_grad(set_to_none=True)
        want = _step(cfg, other, opt2, batch, StepSeeds(gen, cuda_device))
        assert torch.equal(loss, want[0])
    torch.cuda.synchronize()
    _equal_states(model, opt, other, opt2)
