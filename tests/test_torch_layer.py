"""One GPSLayer (CustomGatedGCN+Transformer, BatchNorm) of the port against
the JAX layer with the same weights and non-trivial BatchNorm statistics, on
the same blocked batch, in evaluation and in a training step (dropout 0:
the JAX layer draws its dropout seeds from flax's RNG, which the port cannot
reproduce; ``test_torch_grad.py`` holds the kernels with dropout on). The
JAX side runs both of its paths: the merged front (``GGPS_FUSED_FRONT=1``)
and the unmerged pipeline (``=0``). f32; tolerance rtol = atol = 1e-4 (a
layer chains three kernels, two BatchNorm applies and the final norm; sums
run in another order), the atol of a gradient scaled by its tensor's
largest entry (its entries are sums over rows that cancel)."""
import jax
import numpy as np
import pytest
import torch

from tests.test_fused_gatedgcn import _blocked_batch

torch.set_num_threads(2)

RTOL = ATOL = 1e-4


def randomize_norms(params, batch_stats, seed=0):
    """Copies of flax trees with every MaskedBatchNorm's scale/bias and
    running mean/var drawn from a seeded numpy generator (var > 0)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if not isinstance(t, dict):
            return np.asarray(t)
        out = {k: walk(v) for k, v in t.items()}
        if "mean" in out and "var" in out:
            out["mean"] = (0.2 * rng.standard_normal(out["mean"].shape)
                           ).astype(np.float32)
            out["var"] = (0.5 + rng.random(out["var"].shape)).astype(np.float32)
        if "scale" in out and "bias" in out:
            out["scale"] = (1 + 0.1 * rng.standard_normal(out["scale"].shape)
                            ).astype(np.float32)
            out["bias"] = (0.1 * rng.standard_normal(out["bias"].shape)
                           ).astype(np.float32)
        return out

    return walk(jax.device_get(params)), walk(jax.device_get(batch_stats))


def torch_batch(jb):
    """The port's GraphBatch holding the same arrays as a JAX GraphBatch."""
    from graphgps_torch.data.graph import GraphBatch

    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa
    ef = t(jb.edge_feat)
    return GraphBatch(
        node_feat=t(jb.node_feat).int(),
        edge_feat=None if ef is None else ef.int(),
        senders=t(jb.senders).int(), receivers=t(jb.receivers).int(),
        node_mask=t(jb.node_mask).bool(), edge_mask=t(jb.edge_mask).bool(),
        graph_mask=t(jb.graph_mask).bool(), y=t(jb.y),
        pe={k: t(v) for k, v in jb.pe.items()}, num_graphs=jb.num_graphs,
        max_nodes=jb.max_nodes, edge_block=jb.edge_block)


@pytest.mark.parametrize("front,act", [("1", "gelu"), ("0", "gelu"),
                                       ("1", "relu")])
def test_gps_layer_matches_jax(monkeypatch, front, act):
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    monkeypatch.setenv("GGPS_FUSED_FRONT", front)
    batch, x, e, *_ = _blocked_batch(8, 16, 32, 128, seed=5)
    jl = JaxGPSLayer(dim_h=128, local_gnn_type="CustomGatedGCN",
                     global_model_type="Transformer", num_heads=4,
                     batch_norm=True, act=act)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    xo, eo = jl.apply({"params": params, "batch_stats": stats}, batch, x, e,
                      False)

    layer = GPSLayer(128, 4, act=act).eval()
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    with torch.no_grad():
        txo, teo = layer(torch_batch(batch), torch.from_numpy(np.array(x)),
                         torch.from_numpy(np.array(e)))
    np.testing.assert_allclose(txo.numpy(), np.asarray(xo), rtol=RTOL,
                               atol=ATOL, err_msg="x")
    np.testing.assert_allclose(teo.numpy(), np.asarray(eo), rtol=RTOL,
                               atol=ATOL, err_msg="e")
    assert (txo.numpy()[~np.asarray(batch.node_mask)] == 0).all()


def test_front_args_share_batch_index_and_weights():
    """Every layer hands the front the batch's graph-local endpoints and
    float masks, made once per batch, and its own joint weight as stored
    (no per-call copy)."""
    from graphgps_torch.models.gps_layer import GPSLayer

    batch, x, e, *_ = _blocked_batch(4, 8, 16, 128, seed=2)
    tb = torch_batch(batch)
    xt, et = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(e))
    layers = [GPSLayer(128, 4).eval() for _ in range(2)]
    a0, a1 = (lyr.local.front_args(tb, xt, et, lyr.front_pack())
              for lyr in layers)
    for i in range(2, 6):
        assert a0[i] is a1[i]
    assert a0[9] is layers[0].w_front and a0[9].shape == (128, 7 * 128)
    B, N, E = tb.num_graphs, tb.max_nodes, tb.edge_block
    s_loc, r_loc, em, nm = tb.front_index
    base = np.arange(B)[:, None] * N
    for loc, flat in ((s_loc, batch.senders), (r_loc, batch.receivers)):
        assert loc.dtype == torch.int32 and loc.shape == (B, E)
        np.testing.assert_array_equal(
            loc.numpy(), np.asarray(flat).reshape(B, E) - base)
        assert ((loc >= 0) & (loc < N)).all()
    np.testing.assert_array_equal(
        em.numpy(), np.asarray(batch.edge_mask, np.float32).reshape(B, E))
    np.testing.assert_array_equal(
        nm.numpy(), np.asarray(batch.node_mask, np.float32).reshape(B, N))


@pytest.mark.parametrize("front", ["1", "0"])
def test_gps_layer_train_step_matches_jax(monkeypatch, front):
    """Training mode: outputs, the updated running statistics of all four
    norms, and the gradients of every parameter and of x and e under random
    cotangents."""
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    monkeypatch.setenv("GGPS_FUSED_FRONT", front)
    batch, x, e, *_ = _blocked_batch(8, 16, 32, 128, seed=5)
    jl = JaxGPSLayer(dim_h=128, local_gnn_type="CustomGatedGCN",
                     global_model_type="Transformer", num_heads=4,
                     batch_norm=True, act="gelu")
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32)
            for a in (x, e)]

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x, e,
                            True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    (jxo, jeo), vjp, jstats = jax.vjp(f, params, x, e, has_aux=True)
    jgp, jgx, jge = vjp(tuple(cots))

    layer = GPSLayer(128, 4, act="gelu").train()
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx, te = (torch.from_numpy(np.array(a)).requires_grad_() for a in (x, e))
    txo, teo = layer(torch_batch(batch), tx, te)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(
        (txo, teo), [tx, te, *layer.parameters()],
        [torch.from_numpy(c) for c in cots])

    def close(got, want, msg, scaled=False):
        want = np.asarray(want)
        atol = ATOL * (max(1.0, float(np.abs(want).max())) if scaled else 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=atol, err_msg=msg)

    close(txo, jxo, "x")
    close(teo, jeo, "e")
    close(grads[0], jgx, "dx", True)
    close(grads[1], jge, "de", True)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[2:]):
        close(g, want_g[name], f"d{name}", True)
    want_s = gps_layer_state_dict(params, jax.device_get(jstats))
    got_s = layer.state_dict()
    running = [k for k in want_s if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 8
    for k in running:
        close(got_s[k], want_s[k], k)
        assert not np.allclose(want_s[k], gps_layer_state_dict(params, stats)[k])


def test_gps_layer_refuses_training():
    """What still refuses in training: a layer with dropout and no dropout
    generator, and a dropout rate of 1 or more."""
    from graphgps_torch.models.gps_layer import GPSLayer

    batch, x, e, *_ = _blocked_batch(2, 8, 8, 128, seed=2)
    tb = torch_batch(batch)
    xt, et = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(e))
    layer = GPSLayer(128, 4, dropout=0.1, attn_dropout=0.1).train()
    with pytest.raises(ValueError, match="generator"):
        layer(tb, xt, et)
    layer = GPSLayer(128, 4, dropout=1.0).train()
    with pytest.raises(ValueError, match="outside"):
        layer(tb, xt, et, torch.Generator().manual_seed(0))
