"""The port's fused GPS attention (``fused_gps_attention``: QKV projection,
key-masked attention with dropout on the probabilities, out-projection) and
the GPS layer's rung that runs it, against the JAX package on the CPU.

The JAX function runs as its Pallas kernel in interpret mode on the shapes
of ``tests/test_fused_attn.py`` (ragged graphs and one with no real node),
the port's through its plain version (CPU tensors); forward and every
gradient under random cotangents. Dropout: the TPU kernel's bits cannot be
reproduced, so ``fused_gps_attn._keep_mask`` is patched from here to the
port's counter hash over the (B·H·N, N) view, with ``GGPS_FUSED_G = B`` so
that the kernel's grid has one step; the patch counts its calls.

The layer and a 2-layer model at d = 128 take the port's fused rung
(``GGPS_FUSED_AUTO=1``) with the merged front off (``GGPS_FUSED_FRONT=0``);
the JAX layer off the TPU computes the same function through its dense
attention, its draws patched as in ``test_torch_unmerged.py``. The merged
and the unmerged port models give the same predictions from one set of
weights, and a checkpoint resumes on either path. JAX is imported inside the
tests that use it, so the card-only test runs on a machine without it.

Tolerance, f32: the function rtol = 1e-5, atol = 1e-5 × the tensor's
largest entry; layer and model rtol = atol = 1e-4 (PERF.md §2)."""
import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed

# by its file name: the card machine runs these tests without the conftest
from test_torch_wide import _hold_on_card, cuda_device  # noqa: F401

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
SEED = 13579
SHAPES = [(4, 32, 256, 8), (8, 40, 128, 4), (2, 128, 128, 8),
          (3, 16, 256, 16)]


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _inputs(B, N, d, seed=0):
    """``test_fused_attn._setup``'s inputs (ragged masks, a very small
    graph) with graph 1 holding no real node."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, N, d)
    wqkv = f(d, 3 * d) / np.float32(np.sqrt(d))
    bqkv = 0.1 * f(3 * d)
    wo = f(d, d) / np.float32(np.sqrt(d))
    bo = 0.1 * f(d)
    nreal = rng.integers(max(1, N // 4), N + 1, size=(B,))
    nreal[0] = max(1, N // 8)
    nreal[1] = 0
    kmask = (np.arange(N)[None, :] < nreal[:, None]).astype(np.float32)
    return x, kmask, wqkv, bqkv, wo, bo


def _port_keep_mask():
    """The port's site-0 mask with the signature of ``_keep_mask`` (one
    grid step: the block is the whole (B·H·N, N) view), computed inside the
    kernel from iotas as ``drop_bits`` computes it."""
    import jax
    import jax.numpy as jnp
    from tests.test_torch_grad import _mix32

    def keep_mask(seed_ref, shape, rate):
        keep_mask.calls += 1
        t = min(max(int(round(rate * 256)), 1), 255)
        u32 = jnp.uint32
        key = _mix32(u32(SEED) + u32(0x9E3779B9))
        idx = (jax.lax.broadcasted_iota(u32, shape, 0) * u32(shape[1])
               + jax.lax.broadcasted_iota(u32, shape, 1))
        bits = _mix32(idx ^ _mix32(key))
        return ((bits & u32(255)) >= u32(t)).astype(jnp.float32), \
            1.0 / (1.0 - t / 256.0)

    keep_mask.calls = 0
    return keep_mask


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,N,d,H", SHAPES)
def test_gps_attention_matches_jax(monkeypatch, B, N, d, H, rate):
    """y on every row and the gradients of x and the four weights; the
    backward wrapper agrees with autograd through the function."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import fused_gps_attn
    from graphgps_torch.ops.kernels.gps_attention import (
        fused_gps_attention, gps_attention_backward)

    keep = _port_keep_mask()
    monkeypatch.setattr(fused_gps_attn, "_keep_mask", keep)
    monkeypatch.setenv("GGPS_FUSED_G", str(B))
    x, kmask, wqkv, bqkv, wo, bo = _inputs(B, N, d)
    gy = np.random.default_rng(9).standard_normal((B, N, d)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda x_, *w: fused_gps_attn.fused_gps_attention(
            x_, jnp.asarray(kmask), *w, jnp.asarray(SEED, jnp.int32), H,
            rate), x, wqkv, bqkv, wo, bo)
    want_g = vjp(jnp.asarray(gy))
    # forward and backward each drew the mask once
    assert keep.calls == (2 if rate > 0 else 0)

    ins = [torch.from_numpy(a).requires_grad_() for a in
           (x, wqkv, bqkv, wo, bo)]
    tm = torch.from_numpy(kmask)
    got = fused_gps_attention(ins[0], tm, *ins[1:], SEED, H, rate)
    got_g = torch.autograd.grad(got, ins, torch.from_numpy(gy))
    _close(got, want, "y")
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got_g,
                          want_g):
        _close(a, b, name)
    # the graph with no real node attends uniformly and passes gradient
    assert float(got_g[0][1].abs().max()) > 0
    again = gps_attention_backward(ins[0].detach(), tm,
                                   *(t.detach() for t in ins[1:]), SEED, H,
                                   rate, torch.from_numpy(gy))
    for a, b in zip(again, got_g):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gps_attention_draws_the_dense_rungs_bits(rate):
    """At the same seed the plain version draws the masks of the layer's
    dense ``mha`` rung: the two give the same output and gradients."""
    from graphgps_torch.ops.kernels.common import apply_dropout
    from graphgps_torch.ops.kernels.gps_attention import fused_gps_attention
    from graphgps_torch.ops.mha import merge_heads, mha, split_heads

    B, N, d, H = 3, 16, 128, 4
    x, kmask, wqkv, bqkv, wo, bo = (torch.from_numpy(a) for a in
                                    _inputs(B, N, d, 4))
    kmask[1] = 1.0      # the dense rung's masked logits pass no gradient
    xs = [x.clone().requires_grad_() for _ in range(2)]
    got = fused_gps_attention(xs[0], kmask, wqkv, bqkv, wo, bo, SEED, H, rate)
    qkv = xs[1] @ wqkv + bqkv
    q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H) for i in range(3))
    drop = None
    if rate > 0:
        drop = lambda p: apply_dropout(p, SEED, 0, rate)  # noqa: E731
    want = merge_heads(mha(q, k, v, kmask > 0, drop)) @ wo + bo
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g1, g2 = (torch.autograd.grad(o.sum(), i)[0]
              for o, i in ((got, xs[0]), (want, xs[1])))
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)


def test_gps_attention_refuses_other_devices_and_rates():
    from graphgps_torch.ops.kernels.gps_attention import fused_gps_attention

    args = [torch.from_numpy(a) for a in _inputs(2, 8, 128)]
    with pytest.raises(ValueError, match="dropout"):
        fused_gps_attention(*args, 0, 4, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gps_attention(*(a.to("meta") for a in args), 0, 4, 0.0)


def test_fused_rung_dispatch(monkeypatch):
    """JAX's gate: its envelope, no narrower (the kernels take every head
    width up to 128 node slots), eligible shapes under auto from 8,192 rows
    of B·N on, or as ``GGPS_FUSED_AUTO`` forces it; fused outside the
    envelope raises JAX's ValueError."""
    from graphgps_torch.models.gps_layer import (GPSLayer, fused_auto_wins,
                                                 fused_eligible)
    from graphgps_tpu.ops.pallas import fused_gps_attn

    monkeypatch.delenv("GGPS_FUSED_AUTO", raising=False)
    assert fused_eligible(40, 256, 8) and fused_eligible(128, 128, 4)
    assert not fused_eligible(40, 96, 4)        # not lane-aligned
    assert not fused_eligible(36, 256, 8)       # N % 8
    assert not fused_eligible(136, 256, 8)      # N > 128
    assert fused_eligible(128, 256, 4) and fused_eligible(128, 512, 1)
    for N in range(8, 145, 4):
        for d in (64, 96, 128, 256, 384, 512):
            for H in (1, 2, 3, 4, 8, 16):
                assert fused_eligible(N, d, H) == fused_gps_attn.fused_eligible(
                    N, d, H, bias=None, return_attn=False), (N, d, H)
    assert fused_auto_wins(256, 40) and not fused_auto_wins(32, 40)
    monkeypatch.setenv("GGPS_FUSED_AUTO", "1")
    assert fused_auto_wins(1, 8)
    monkeypatch.setenv("GGPS_FUSED_AUTO", "0")
    assert not fused_auto_wins(256, 40)
    layer = GPSLayer(128, 4, attn_impl="fused")
    assert layer.takes_fused(2, 16)
    assert GPSLayer(256, 4, attn_impl="fused").takes_fused(2, 128)
    with pytest.raises(ValueError, match="gt.attn_impl='fused' needs"):
        layer.takes_fused(2, 20)
    assert not GPSLayer(128, 4, attn_impl="dense").takes_fused(256, 40)


class FusedCalls:
    """Counts the GPS layer's calls of ``fused_gps_attention``."""

    def __init__(self, monkeypatch):
        from graphgps_torch.models import gps_layer

        real = gps_layer.fused_gps_attention
        self.calls = 0

        def counted(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(gps_layer, "fused_gps_attention", counted)


def _switch(monkeypatch, front: str, auto: str = "1"):
    monkeypatch.setenv("GGPS_FUSED_FRONT", front)
    monkeypatch.setenv("GGPS_FUSED_AUTO", auto)


def _jax_patches(monkeypatch, d):
    """``test_torch_unmerged.Patches``, after importing the JAX front's
    module: it binds ``fused_tail._keep`` when first imported (the JAX layer
    imports it inside its call), so a first import under the patch would
    keep the patched rule for the rest of the process."""
    from graphgps_tpu.ops.pallas import fused_layer  # noqa: F401
    from tests.test_torch_unmerged import Patches

    return Patches(monkeypatch, d)


@pytest.mark.parametrize("train", [False, True])
def test_layer_fused_rung_matches_jax(monkeypatch, train):
    """One layer at d = 128, H = 4 on 8 graphs of 16 node slots, the merged
    front off and the fused rung forced, against the JAX unmerged layer: in
    evaluation, and in training at ogbg-molhiv's rates (0.05, 0.5 on the
    attention) outputs, the gradients of x, e and every parameter under
    random cotangents, and the updated running statistics."""
    import jax
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_layer import randomize_norms, torch_batch
    from tests.test_torch_unmerged import (ATTN_DROP, DROP, RTOL as LRTOL,
                                           _close as lclose, _jax_layer)

    d = 128
    _switch(monkeypatch, "0")
    patches = _jax_patches(monkeypatch, d)
    fused = FusedCalls(monkeypatch)
    rates = (DROP, ATTN_DROP) if train else (0.0, 0.0)
    batch, x, e, *_ = _blocked_batch(8, 16, 32, d, seed=5)
    jl = _jax_layer(d, "relu", *rates)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32)
            for a in (x, e)]

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x, e,
                            train, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return out, mut.get("batch_stats", stats)

    (jxo, jeo), vjp, jstats = jax.vjp(f, params, x, e, has_aux=True)
    assert patches.attn_calls == (1 if train else 0)

    layer = GPSLayer(d, 4, act="relu", dropout=rates[0],
                     attn_dropout=rates[1]).train(train)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx, te = (torch.from_numpy(np.array(a)).requires_grad_() for a in (x, e))
    tb = torch_batch(batch)
    assert layer.holds_front and not layer.takes_merged(tb)
    assert not layer.takes_merged(tb)
    txo, teo = layer(tb, tx, te, torch.Generator().manual_seed(0))
    assert fused.calls == 1
    lclose(txo, jxo, "x")
    lclose(teo, jeo, "e")
    if not train:
        return
    jgp, jgx, jge = vjp(tuple(cots))
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((txo, teo), [tx, te, *layer.parameters()],
                                [torch.from_numpy(c) for c in cots])
    lclose(grads[0], jgx, "dx", True)
    lclose(grads[1], jge, "de", True)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[2:]):
        lclose(g, want_g[name], f"d{name}", True)
    want_s = gps_layer_state_dict(params, jax.device_get(jstats))
    got_s = layer.state_dict()
    running = [k for k in want_s if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 8
    for k in running:
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=LRTOL,
                                   atol=LRTOL, err_msg=k)


# the ogbg-molhiv recipe at d = 128, 2 layers (16 node slots, batches of
# 8), with gelu: at relu a unit of layer 1's FFN lies within rounding of the
# kink on this batch, and the two packages' summation orders put it on
# either side (the relu-kink trap of ROADMAP.md, Queue 3), which
# parts its gradient row by ~2% on the dense rung as on the fused one
WIDE128 = ("gt.dim_hidden", "128", "gnn.dim_inner", "128", "gnn.act", "gelu")


def test_model_fused_rung_matches_jax(monkeypatch):
    """A 2-layer model at d = 128, H = 4 (ogbg-molhiv's recipe at that
    width, gelu), the merged front off and the fused rung forced: evaluation
    logits on a full batch, then one whole train step (dropout 0.05 / 0.5
    through the port's masks, BCE, adamW, clipping): loss, clipped
    gradients by the port's parameter names, updated running statistics."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_layer import randomize_norms
    from tests.test_torch_train import _clip
    from tests.test_torch_unmerged import RTOL as LRTOL, molhiv_loaders

    _switch(monkeypatch, "0")
    patches = _jax_patches(monkeypatch, 128)
    fused = FusedCalls(monkeypatch)
    jcfg, _, jloaders, tcfg, tsplits, tloaders = molhiv_loaders(
        *WIDE128, "optim.base_lr", "1e-3", "optim.scheduler", "none")
    dim_out = infer_dims(tcfg, tsplits)
    _, jb = next(iter(jloaders["train"]))
    _, tb = next(iter(tloaders["train"]))
    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=9)
    model = build_model(tcfg, dim_out)
    load_flax(model, params, stats)

    want, _ = jmodel.apply({"params": params, "batch_stats": stats}, jb,
                           False)
    with torch.no_grad():
        got, _ = model.eval()(tb)
    assert fused.calls == 2
    m = tb.graph_mask.numpy()
    np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                               rtol=LRTOL, atol=LRTOL, err_msg="eval")

    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    jgrad = jax.jit(jax.value_and_grad(raw["forward"], has_aux=True))
    jstep = jax.jit(raw["train"])
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                           jnp.asarray(0))
    state, *_ = jstep(state, jb, rng)
    assert patches.attn_calls > 0 and patches.combine.calls > 0
    model.train()
    opt = build_optimizer(tcfg, model.parameters())
    loss, *_ = train_step(tcfg, model, opt, tb,
                          torch.Generator().manual_seed(0))
    assert fused.calls == 4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LRTOL,
                               atol=LRTOL, err_msg="loss")
    named = dict(model.named_parameters())
    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    assert "layers.0.w_front" in want_g and set(want_g) <= set(named)
    for k, g in want_g.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), g, rtol=LRTOL,
            atol=LRTOL * max(1e-3, np.abs(g).max()), err_msg=f"grad {k}")
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats)).items()}
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=LRTOL,
                                       atol=LRTOL, err_msg=k)


def _deep_model(*extra):
    """The GPS-deep recipe at test size (d = 128, 4 heads, 2 layers, 16
    node slots), seeded, with seeded norm affines and running statistics;
    and its config, splits and loaders."""
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.common import MaskedBatchNorm
    from graphgps_torch.models.networks import build_model
    from tests.test_torch_data import small_cfgs

    _, cfg = small_cfgs(*extra)
    splits = load_dataset(cfg)
    loaders = create_loaders(cfg, splits, "cpu")
    torch.manual_seed(3)
    model = build_model(cfg, infer_dims(cfg, splits))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                n = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model, cfg, splits, loaders


def test_merged_and_fused_rung_predict_alike(monkeypatch):
    """One set of weights, GPS-deep at test size in evaluation: the merged
    front and the unmerged path with the fused rung give the same
    predictions on a full and on a partial batch."""
    model, _, _, loaders = _deep_model()
    fused = FusedCalls(monkeypatch)
    model.eval()
    for split in ("train", "val"):
        _, batch = next(iter(loaders[split]))
        outs = []
        for front in ("1", "0"):
            _switch(monkeypatch, front)
            with torch.no_grad():
                outs.append(model(batch)[0])
        assert fused.calls == (2 if split == "train" else 4)
        m = batch.graph_mask
        torch.testing.assert_close(outs[1][m], outs[0][m], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("first,then", [("1", "0"), ("0", "1")])
def test_checkpoint_resumes_across_the_front_switch(monkeypatch, tmp_path,
                                                    first, then):
    """A checkpoint (model and adamW state) written after a training step
    on one path resumes on the other: the next step there gives the loss,
    the gradients and the updated parameters of the same step on the first
    path (dropout off, so the two paths' seed draws do not matter). Updated
    parameters as in ``test_torch_unmerged.py``: an entry whose gradient is
    below 1e-7 (a bias a BatchNorm removes) may move by up to 2·lr in either
    run; every other entry within 1e-5 plus 1e-2·lr."""
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train import checkpoint
    from graphgps_torch.train.loop import train_step

    lr = 1e-3
    opts = ("gt.dropout", "0.0", "gt.attn_dropout", "0.0")
    model, cfg, _, loaders = _deep_model(*opts)
    it = iter(loaders["train"])
    batches = [next(it)[1] for _ in range(2)]
    _switch(monkeypatch, first)
    opt = build_optimizer(cfg, model.parameters())
    set_lr(opt, lr)
    train_step(cfg, model.train(), opt, batches[0], None)
    checkpoint.save_ckpt(str(tmp_path), model, opt, 0)

    runs = []
    for front in (first, then):
        _switch(monkeypatch, front)
        fresh, *_ = _deep_model(*opts)
        fopt = build_optimizer(cfg, fresh.parameters())
        assert checkpoint.load_ckpt(str(tmp_path), fresh, fopt) == 1
        set_lr(fopt, lr)
        fused = FusedCalls(monkeypatch)
        loss, *_ = train_step(cfg, fresh.train(), fopt, batches[1], None)
        assert fused.calls == (2 if front == "0" else 0)
        assert all(int(st["step"]) == 2 for st in fopt.state.values())
        runs.append((float(loss), {k: (p.detach().clone(), p.grad.clone())
                                   for k, p in fresh.named_parameters()}))
    (loss0, want), (loss1, got) = runs
    assert loss1 == pytest.approx(loss0, rel=1e-5)
    for k, (p0, g0) in want.items():
        p1, g1 = got[k]
        # a gradient that a BatchNorm removes is rounding noise: the floor
        torch.testing.assert_close(
            g1, g0, rtol=1e-4, atol=1e-4 * max(1e-3, float(g0.abs().max())),
            msg=k)
        tol = torch.where(g0.abs() < 1e-7, 2 * lr, 1e-5 + 1e-2 * lr)
        assert ((p1 - p0).abs() <= tol).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d,H", [(8, 40, 256, 8), (3, 128, 128, 8),
                                     (4, 16, 256, 16), (4, 128, 256, 4),
                                     (3, 40, 384, 8), (2, 128, 128, 1)])
def test_cuda_gps_attention_matches_plain(cuda_device, B, N, d, H):  # noqa: F811
    """On the card: the kernel through autograd against its plain version
    on the same CUDA tensors (ragged graphs, one with no real node; heads of
    16 to 128 columns, one to four chunks of the attention body), at rate 0
    and 0.1: outputs and gradients close, two backward runs equal in
    every bit, one launch of each wrapper per call. Run it from the
    repository root: ``python -m pytest --noconftest -o addopts="" -p
    no:cacheprovider -m cuda tests/test_torch_gps_attention.py``."""
    from graphgps_torch.ops.kernels import gps_attention as ga

    x, kmask, *w = (torch.from_numpy(a).to(cuda_device)
                    for a in _inputs(B, N, d, 2))
    seed = device_seed(SEED, cuda_device)
    for rate in (0.0, 0.1):
        _hold_on_card(
            lambda x_, *w_: ga.fused_gps_attention(x_, kmask, *w_, seed, H,
                                                   rate),
            lambda x_, *w_: ga.gps_attention_plain(x_, kmask, *w_, seed, H,
                                                   rate),
            [x, *w], (ga.fused_gps_attention, ga.gps_attention_backward))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 40, 128])
@pytest.mark.parametrize("d,H", [(256, 8), (256, 4), (304, 4)])
def test_cuda_gps_attention_key_mask(cuda_device, N, d, H):  # noqa: F811
    """On the card: the key-mask mode of the tensor-core attention body
    through ``fused_gps_attention`` against its plain version, on a key
    mask that is not a prefix (each key real with probability 0.7, and one
    graph with no real node), at N = 8, 40 and 128 node slots and heads of
    32, 64 and 76 columns (GPS-deep, 128-slot graphs, pcqm4m-GPS), forward
    and backward at rate 0 and 0.1: outputs and gradients close, two
    backward runs equal in every bit, one launch of each wrapper per call."""
    from graphgps_torch.ops.kernels import gps_attention as ga

    B = 6
    x, _, *w = (torch.from_numpy(a).to(cuda_device)
                for a in _inputs(B, N, d, 5))
    rng = np.random.default_rng(N + d + H)
    km = (rng.random((B, N)) < 0.7).astype(np.float32)
    km[2] = 0.0
    km[3, 0] = 0.0
    km[3, N - 1] = 1.0
    kmask = torch.from_numpy(km).to(cuda_device)
    seed = device_seed(SEED, cuda_device)
    for rate in (0.0, 0.1):
        _hold_on_card(
            lambda x_, *w_: ga.fused_gps_attention(x_, kmask, *w_, seed, H,
                                                   rate),
            lambda x_, *w_: ga.gps_attention_plain(x_, kmask, *w_, seed, H,
                                                   rate),
            [x, *w], (ga.fused_gps_attention, ga.gps_attention_backward))
