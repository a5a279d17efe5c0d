"""The port's unmerged GPS layer (widths that are no multiple of 128:
standalone GatedGCN core, Transformer branch in PyTorch ops, drop-add,
combine+FFN) against the JAX package on the CPU: one layer in evaluation
(plain tails and FFN) and in a training step with dropout 0.05 on the
residual branches and 0.5 on the attention probabilities (the ogbg-molhiv
rates: fused tails, deferred combine), and a 2-layer model at d = 64 built
from the ogbg-molhiv recipe for two whole train steps against
``_build_raw_steps(...)["train"]``.

Dropout: neither the TPU kernels' bits nor flax's keys can be reproduced, so
the tests give both sides the port's masks and the same four seeds per layer
(edge tail, attention, drop-add, combine+FFN), patching from here and
changing nothing in either package: JAX's ``_keep`` in ``fused_tail`` and
``fused_combine`` becomes the port's counter hash over each site's true
width (the TPU kernels zero-pad d = 64 to 128 lanes; the port hashes the
unpadded view), ``graphgps_tpu.ops.mha.keep_mask_u8`` becomes the same hash
over the (B·H·N, N) view of the probabilities, ``jax.random.bits`` hands the
three kernel seeds out in the order the JAX layer draws them, and the port's
``draw_seeds`` returns the four. Each patch counts its calls, so a JAX path
that fell back to ``nn.Dropout`` would fail the test rather than pass it.

Tolerance, f32: rtol = atol = 1e-4 (a layer chains four kernels, three
BatchNorms and a softmax; sums run in another order), the atol of a gradient
scaled by its tensor's largest entry (its entries are sums that cancel)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.test_fused_gatedgcn import _blocked_batch
from tests.test_torch_grad import _mix32
from tests.test_torch_layer import randomize_norms, torch_batch

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
DROP, ATTN_DROP = 0.05, 0.5
# edge tail, attention, drop-add, combine+FFN
SEEDS = [1111111, 222222222, 33333, 2 ** 31 - 5]


def keep_at(widths):
    """The port's dropout rule with the JAX ``_keep`` signature, for a
    kernel whose site ``i`` has true width ``widths[i]`` (its block may be
    zero-padded to more lanes; padded lanes carry zeros)."""
    def keep(seed_ref, offset, shape, rate):
        keep.calls += 1
        t = min(max(int(round(rate * 256)), 1), 255)
        u32 = jnp.uint32
        key = _mix32(seed_ref[0].astype(u32)
                     + u32(0x9E3779B9) * u32(offset + 1))
        row = (pl.program_id(0).astype(u32) * u32(shape[0])
               + jax.lax.broadcasted_iota(u32, shape, 0))
        idx = (row * u32(widths[offset])
               + jax.lax.broadcasted_iota(u32, shape, 1))
        bits = _mix32(idx ^ _mix32(key))
        return ((bits & u32(255)) >= u32(t)).astype(jnp.float32), \
            1.0 / (1.0 - t / 256.0)

    keep.calls = 0
    return keep


class Patches:
    def __init__(self, monkeypatch, d):
        from graphgps_tpu.ops import mha as jmha
        from graphgps_tpu.ops.pallas import fused_combine, fused_tail
        from graphgps_torch.models import gps_layer
        from graphgps_torch.ops.kernels.common import drop_bits

        self.tail = keep_at({0: d})
        self.combine = keep_at({0: d, 1: 2 * d, 2: d})
        self.bits_calls = self.attn_calls = 0
        real_bits = jax.random.bits
        kernel_seeds = [SEEDS[0], SEEDS[2], SEEDS[3]]

        def bits(key, shape=(), dtype=None):
            if tuple(shape) != ():
                return real_bits(key, shape, dtype)
            seed = kernel_seeds[self.bits_calls % 3]
            self.bits_calls += 1
            return jnp.asarray(seed, jnp.uint32)

        def keep_mask_u8(rng, rate, shape):
            self.attn_calls += 1
            t = min(max(int(round(rate * 256)), 1), 255)
            rows = int(np.prod(shape[:-1]))
            b = drop_bits(SEEDS[1], 0, rows, shape[-1]).numpy()
            return jnp.asarray(((b & 255) >= t).reshape(shape)), 1.0 - t / 256.0

        monkeypatch.setattr(fused_tail, "_keep", self.tail)
        monkeypatch.setattr(fused_combine, "_keep", self.combine)
        monkeypatch.setattr(jmha, "keep_mask_u8", keep_mask_u8)
        monkeypatch.setattr(jax.random, "bits", bits)
        monkeypatch.setattr(gps_layer, "draw_seeds",
                            lambda gen, n: list(SEEDS[:n]))


def _close(got, want, msg, scaled=False):
    want = np.asarray(want)
    atol = ATOL * (max(1.0, float(np.abs(want).max())) if scaled else 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=atol, err_msg=msg)


def _jax_layer(d, act, dropout=0.0, attn_dropout=0.0):
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer

    return JaxGPSLayer(dim_h=d, local_gnn_type="CustomGatedGCN",
                       global_model_type="Transformer", num_heads=4,
                       batch_norm=True, act=act, dropout=dropout,
                       attn_dropout=attn_dropout)


@pytest.mark.parametrize("d,act", [(64, "relu"), (72, "gelu"), (128, "relu")])
def test_unmerged_layer_eval_matches_jax(monkeypatch, d, act):
    """Evaluation at a width that is no multiple of 128: the standalone
    core, then plain tails, branch sum and FFN on both sides. At d = 128
    with the merged front off (as for graphs of more than 128 node slots)
    the tails are deferred in evaluation too."""
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    monkeypatch.setenv("GGPS_FUSED_FRONT", "0")
    batch, x, e, *_ = _blocked_batch(8, 16, 32, d, seed=5)
    jl = _jax_layer(d, act)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    xo, eo = jl.apply({"params": params, "batch_stats": stats}, batch, x, e,
                      False)

    layer = GPSLayer(d, 4, act=act, dropout=DROP,
                     attn_dropout=ATTN_DROP).eval()
    tb = torch_batch(batch)
    assert not layer.takes_merged(tb) and layer.defer == (d == 128)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    with torch.no_grad():
        txo, teo = layer(tb, torch.from_numpy(np.array(x)),
                         torch.from_numpy(np.array(e)))
    _close(txo, xo, "x")
    _close(teo, eo, "e")
    assert (txo.numpy()[~np.asarray(batch.node_mask)] == 0).all()


@pytest.mark.parametrize("d,rates", [(64, (DROP, ATTN_DROP)),
                                     (72, (DROP, ATTN_DROP)),
                                     (72, (0.0, 0.0))])
def test_unmerged_layer_train_step_matches_jax(monkeypatch, d, rates):
    """Training mode: outputs, the updated running statistics of all four
    norms, and the gradients of every parameter and of x and e under random
    cotangents; with dropout (the deferred path through the fused tails and
    combine+FFN) and without (the plain tails)."""
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    patches = Patches(monkeypatch, d)
    batch, x, e, *_ = _blocked_batch(8, 16, 32, d, seed=5)
    jl = _jax_layer(d, "relu", *rates)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32)
            for a in (x, e)]

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x, e,
                            True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return out, mut["batch_stats"]

    (jxo, jeo), vjp, jstats = jax.vjp(f, params, x, e, has_aux=True)
    jgp, jgx, jge = vjp(tuple(cots))
    if rates[0] > 0:
        # edge tail, drop-add and combine drew a seed each; the kernels and
        # the attention took the port's masks
        assert patches.bits_calls == 3 and patches.attn_calls == 1
        assert patches.tail.calls >= 4 and patches.combine.calls >= 6
    else:
        assert patches.bits_calls == patches.tail.calls == 0

    layer = GPSLayer(d, 4, act="relu", dropout=rates[0],
                     attn_dropout=rates[1]).train()
    assert layer.defer == (rates[0] > 0)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx, te = (torch.from_numpy(np.array(a)).requires_grad_() for a in (x, e))
    txo, teo = layer(torch_batch(batch), tx, te,
                     torch.Generator().manual_seed(0))
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(
        (txo, teo), [tx, te, *layer.parameters()],
        [torch.from_numpy(c) for c in cots])

    _close(txo, jxo, "x")
    _close(teo, jeo, "e")
    _close(grads[0], jgx, "dx", True)
    _close(grads[1], jge, "de", True)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[2:]):
        _close(g, want_g[name], f"d{name}", True)
    want_s = gps_layer_state_dict(params, jax.device_get(jstats))
    got_s = layer.state_dict()
    running = [k for k in want_s if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 8
    for k in running:
        _close(got_s[k], want_s[k], k)
        assert not np.allclose(want_s[k], gps_layer_state_dict(params, stats)[k])


def test_unmerged_layer_seeds_reach_their_sites(monkeypatch):
    """Each of the four seeds the layer draws moves the output (the
    attention seed too), and only the edge tail's reaches the edge output."""
    from graphgps_torch.models import gps_layer

    batch, x, e, *_ = _blocked_batch(4, 8, 16, 64, seed=2)
    tb = torch_batch(batch)
    xt, et = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(e))
    torch.manual_seed(0)
    layer = gps_layer.GPSLayer(64, 4, dropout=DROP,
                               attn_dropout=ATTN_DROP).train()
    state = copy.deepcopy(layer.state_dict())

    def run(seeds):
        # the same running statistics (the kernels' moment shifts) each time
        layer.load_state_dict(state)
        monkeypatch.setattr(gps_layer, "draw_seeds", lambda gen, n: seeds[:n])
        with torch.no_grad():
            return layer(tb, xt, et)

    base = run(SEEDS)
    assert all(torch.equal(a, b) for a, b in zip(base, run(SEEDS)))
    for i in range(4):
        seeds = list(SEEDS)
        seeds[i] += 1
        xo, eo = run(seeds)
        assert not (torch.equal(xo, base[0]) and torch.equal(eo, base[1])), i
        assert torch.equal(eo, base[1]) == (i != 0)


def molhiv_loaders(*extra):
    from tests.test_torch_data import MOLHIV_CFG, MOLHIV_SMALL, both_loaders

    return both_loaders(*extra, cfg_path=MOLHIV_CFG, small=MOLHIV_SMALL)


@pytest.mark.parametrize("scan", ["true", "false"])
def test_unmerged_model_eval_matches_jax(scan):
    """The ogbg-molhiv recipe cut to 2 layers (d = 64, 4 heads, mean pooling,
    one logit) in evaluation, the JAX stack scanned and unrolled: logits and
    integer labels on a full and on a partial batch."""
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    jcfg, _, jloaders, tcfg, tsplits, tloaders = molhiv_loaders(
        "parallel.scan_layers", scan)
    dim_out = infer_dims(tcfg, tsplits)
    assert dim_out == 1
    jmodel = jbuild(jcfg, dim_out)
    _, jb = next(iter(jloaders["val"]))
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=9)
    model = build_model(tcfg, dim_out).eval()
    assert not model.layers[0].holds_front
    load_flax(model, params, stats)
    for split in ("val", "train"):
        _, jb = next(iter(jloaders[split]))
        _, tb = next(iter(tloaders[split]))
        want, jtrue = jmodel.apply({"params": params, "batch_stats": stats},
                                   jb, False)
        with torch.no_grad():
            got, true = model(tb)
        assert got.shape == (8, 1) and not true.is_floating_point()
        m = tb.graph_mask.numpy()
        np.testing.assert_array_equal(true.numpy()[m], np.asarray(jtrue)[m])
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def test_unmerged_two_train_steps_match_jax(monkeypatch):
    """Two whole train steps of the ogbg-molhiv recipe at 2 layers (dropout
    0.05 / 0.5 through the patched masks, binary cross-entropy, adamW,
    clipping) on two batches: loss, clipped gradients by the port's
    parameter names, updated parameters and updated running statistics.

    Updated parameters as in ``test_torch_train.py``: an entry whose JAX
    gradient is below 1e-7 in magnitude (a bias a BatchNorm removes) may
    move by up to 2·lr per step in either package and is set to JAX's value
    before the next step; every other entry within rtol = atol = 1e-5 plus
    1e-2·lr."""
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_train import _clip

    lr = 1e-3
    patches = Patches(monkeypatch, 64)
    jcfg, _, jloaders, tcfg, tsplits, tloaders = molhiv_loaders(
        "optim.base_lr", str(lr), "optim.scheduler", "none")
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
    gen = torch.Generator().manual_seed(0)

    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                               jnp.asarray(step))
        old = state_dict_from_flax(jax.device_get(state.params))
        state, jloss2, *_ = jstep(state, jb, rng)
        assert patches.bits_calls % 3 == 0 and patches.bits_calls > 0
        assert patches.attn_calls > 0 and patches.combine.calls > 0
        loss, pred, _, mask = train_step(tcfg, model, opt, tb, gen)
        assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                                   atol=ATOL, err_msg=f"loss {step}")

        want_g = _clip({k: v.numpy() for k, v in
                        state_dict_from_flax(jax.device_get(jg)).items()})
        moved = 0.0
        new = {k: v.numpy() for k, v in
               state_dict_from_flax(jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)).items()}
        assert set(want_g) <= set(named)
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
