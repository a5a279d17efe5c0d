"""Training against the JAX package on the CPU: two whole-model train steps
(GPS-deep recipe cut to 2 layers at d=128, 4 heads, batch 8; Atom+RWSE and
Bond encoders, san_graph head) against ``_build_raw_steps(...)["train"]``,
and the optimizer (optax-rule clipping, adamW, the epoch schedules) against
optax.

The model steps run at dropout 0: the JAX model draws its dropout seeds from
flax's RNG, which the port cannot reproduce (``test_torch_grad.py`` holds
the kernels with dropout on). The layer stack is scanned and rematerialized
on the JAX side (the recipe's ``parallel`` settings) with the merged front.
Tolerances, f32: loss and running statistics rtol = atol = 1e-4 (as the
model's forward); a gradient rtol = 1e-4 with atol 1e-4 × its tensor's
largest entry (entries are sums over rows that cancel)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_data import both_loaders
from tests.test_torch_layer import randomize_norms

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
LR = 1e-3
CLIP = 1.0


def _clip(grads: dict) -> dict:
    """optax.clip_by_global_norm on a flat dict of numpy gradients."""
    n = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                    for g in grads.values()))
    return grads if n < CLIP else {k: g / n * CLIP for k, g in grads.items()}


def test_two_train_steps_match_jax(monkeypatch):
    """Loss, clipped gradients (by the port's parameter names through
    ``weights.py``), updated parameters and updated running statistics after
    each of two steps on two batches. The second step starts from the
    statistics the first one left: a front that folded its moment
    cotangents with a running mean updated in place would fail here.

    Updated parameters: Adam divides each gradient by its own root mean
    square, so an entry whose gradient is zero in exact arithmetic (a bias
    right before a BatchNorm, which removes it) turns f32 rounding noise
    into a step of up to lr. Such entries (|g| < 1e-7 in the JAX step) may
    differ by up to 2·lr per step; every other entry within rtol = atol =
    1e-5 plus 1e-2·lr. Before the second step the port takes JAX's values
    of those entries only: a bias that a BatchNorm removes only in part (B
    of the GatedGCN, whose nodes without edges get num/den = 0) would
    otherwise carry a 2·lr difference into the second forward, and the
    comparison would measure that noise instead of the step."""
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax

    monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
    jcfg, _, jloaders, tcfg, tsplits, tloaders = both_loaders(
        "gt.dropout", "0.0", "gt.attn_dropout", "0.0", "optim.base_lr",
        str(LR), "train.mode", "custom")
    dim_out = infer_dims(tcfg, tsplits)
    jit, tit = iter(jloaders["train"]), iter(tloaders["train"])
    jbatches = [next(jit)[1] for _ in range(2)]
    tbatches = [next(tit)[1] for _ in range(2)]

    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key},
                      jbatches[0], False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=9)
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

    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                               jnp.asarray(step))
        old = state_dict_from_flax(jax.device_get(state.params))
        state, jloss2, *_ = jstep(state, jb, rng)
        loss, pred, _, mask = train_step(tcfg, model, opt, tb, None)
        assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                                   atol=ATOL, err_msg=f"loss {step}")

        want_g = {k: v.numpy() for k, v in
                  state_dict_from_flax(jax.device_get(jg)).items()}
        want_g = _clip(want_g)
        moved = 0.0   # the step did something: the largest clean move
        new = {k: v.numpy() for k, v in
               state_dict_from_flax(jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)).items()}
        for k, g in want_g.items():
            got = named[k].grad.numpy()
            np.testing.assert_allclose(
                got, g, rtol=RTOL, atol=ATOL * max(1e-3, np.abs(g).max()),
                err_msg=f"grad {k} step {step}")
            noisy = np.abs(g) < 1e-7
            tol = np.where(noisy, 2 * LR * (step + 1),
                           1e-5 + 1e-5 * np.abs(new[k]) + 1e-2 * LR)
            diff = np.abs(named[k].detach().numpy() - new[k])
            assert (diff <= tol).all(), (k, step, float(diff.max()))
            moved = max(moved, float(np.abs(new[k] - old[k].numpy())[~noisy]
                                     .max(initial=0.0)))
            with torch.no_grad():
                named[k][torch.from_numpy(noisy)] = torch.from_numpy(
                    new[k][noisy])
        assert moved > 0.5 * LR, (step, moved)
        sd = model.state_dict()
        for k in new:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k} {step}")


def test_optimizer_matches_optax():
    """Six steps of optax-rule clipping + adamW (decoupled weight decay)
    under the epoch schedule, on seeded gradients, two of them above the
    clip norm, against optax's chain with the same learning rates."""
    from graphgps_torch.config import new_cfg
    from graphgps_torch.optim import (build_optimizer, build_schedule,
                                      clip_by_global_norm, set_lr)

    cfg = new_cfg()
    cfg.optim.optimizer = "adamW"
    cfg.optim.base_lr = 1e-2
    cfg.optim.weight_decay = 0.05
    cfg.optim.scheduler = "linear_with_warmup"
    cfg.optim.num_warmup_epochs = 2
    cfg.optim.max_epoch = 6
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * (3.0 if i % 3 == 0 else 0.05))
              .astype(np.float32) for s in shapes] for i in range(6)]

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = build_optimizer(cfg, params)
    schedule = build_schedule(cfg)
    assert [schedule(i) for i in range(6)] == pytest.approx(
        [0.0, 5e-3, 1e-2, 7.5e-3, 5e-3, 2.5e-3])
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.inject_hyperparams(optax.adamw)(
                         learning_rate=0.0, weight_decay=0.05))
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    norms = []
    for i, g in enumerate(grads):
        lr = schedule(i)
        set_lr(opt, lr)
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        norms.append(float(clip_by_global_norm([p.grad for p in params], 1.0)))
        opt.step()
        st[1].hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, st = tx.update([jnp.asarray(gi) for gi in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        want_n = float(optax.global_norm([jnp.asarray(gi) for gi in g]))
        assert norms[-1] == pytest.approx(want_n, rel=1e-6)
        for p, w in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
    assert max(norms) > 1.0 > min(norms)


def test_optimizer_refuses_unported_settings():
    from graphgps_torch.config import new_cfg
    from graphgps_torch.optim import build_optimizer, build_schedule

    cfg = new_cfg()
    cfg.optim.optimizer = "sgd"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    cfg.optim.scheduler = "step"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_schedule(cfg)
