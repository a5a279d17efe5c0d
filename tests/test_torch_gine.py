"""What the ZINC GPS family (``configs/GPS/zinc-GPS*.yaml``,
``configs/debug/zinc-debug.yaml``, ``configs/SAN/zinc-SAN.yaml``: GINE as
the local GNN, TypeDictNode composed with RWSE and LapPE, TypeDictEdge)
brings to the port, against the JAX package on the CPU:

- ``GINELayer`` forward and backward with edge features, without them,
  with the EquivStableLapPE message scale and in the ``wrap_norm_act``
  form (BatchNorm in training); the reference-extracted ``gine_es``
  fixture case;
- ``FeatureEncoder`` for ``TypeDictNode+RWSE``, ``+LapPE`` and
  ``+LapPE+RWSE`` with ``TypeDictEdge`` through the weight bridge, in
  training (RWSE's norm, LapPE's sign flip): x, e, every parameter's
  gradient and the running statistics;
- a ``GINE+Transformer`` GPSLayer at attention dropout 0.5 (dropout 0, as
  published, and 0.2 through the drop-add kernels' plain versions), and at
  zinc-debug's width of 32 with no fused kernel;
- one zinc-GPS+RWSE training step at 2 layers: loss, gradients, updated
  parameters and running statistics (its K-step epoch against JAX's scan
  is a case of ``tests/test_torch_kstep.py``);
- the six configs of the family through ``driver.main`` for one epoch, and
  the family's configs that still refuse, each naming its ROADMAP item.

Dropout: as in ``tests/test_torch_gcn.py`` (``Patches``): both packages take
the port's masks and the same four seeds per layer. Tolerances: layers and
models rtol = atol = 1e-4, a gradient's atol scaled by its tensor's largest
entry; the fixture at the JAX test's own rtol 1e-4, atol 1e-5."""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fused_gatedgcn import _blocked_batch
from tests.test_torch_data import small_cfgs
from tests.test_torch_gcn import DROP, ATTN_DROP, Patches, _close
from tests.test_torch_kstep import ZINC_CFG, ZINC_LAPPE_CFG, ZINC_SMALL
from tests.test_torch_layer import randomize_norms, torch_batch
from tests.test_torch_main import ROOT

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
ZINC_BOTH_CFG = str(ROOT / "configs/GPS/zinc-GPS-LapPE+RWSE.yaml")
SIGNS = np.array([1, 0, 0, 1, 1, 0, 1, 0])   # LapPE, max_freqs 8


# ---------------------------------------------------------------------------
# GINELayer

def _gine_pair(case, d=64):
    """(JAX GINELayer, its train flag, port GINELayer) for ``case``."""
    from graphgps_tpu.models.local_gnn import GINELayer as JaxGINE
    from graphgps_torch.models.local_gnn import GINELayer

    es, wrap = case == "es", case == "wrap"
    jl = JaxGINE(dim=d, equivstable_pe=es, wrap_norm_act=wrap,
                 batch_norm=wrap)
    return jl, wrap, GINELayer(d, equivstable_pe=es, wrap_norm_act=wrap,
                               batch_norm=wrap)


@pytest.mark.parametrize("case", ["e", "no_e", "es", "wrap"])
def test_gine_layer_matches_jax(case):
    """``GINELayer`` on 3 graphs of up to 40 node slots and 96 edge slots
    (padded edges included): the output and the gradients of x, e and
    every parameter under a random cotangent; ``es`` with a random
    ``pe_EquivStableLapPE`` of 8 columns; ``wrap`` in training (BatchNorm's
    batch statistics, the updated running statistics)."""
    import dataclasses

    from graphgps_torch.weights import gine_state_dict, to_torch

    batch, x, e, *_ = _blocked_batch(3, 40, 96, 64, seed=7)
    rng = np.random.default_rng(8)
    if case == "es":
        pe = rng.standard_normal((batch.num_node_slots, 8)).astype(np.float32)
        batch = dataclasses.replace(batch, pe={"pe_EquivStableLapPE":
                                               jnp.asarray(pe)})
    if case == "no_e":
        e = None
    jl, train, layer = _gine_pair(case)
    var = jl.init(jax.random.PRNGKey(2), batch, x, e, False)
    params, stats = randomize_norms(var["params"],
                                    var.get("batch_stats", {}), seed=3)
    params["eps"] = np.float32(0.3)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x,
                            e, train, mutable=["batch_stats"])
        return out[0], mut.get("batch_stats", {})

    args = (params, x) if e is None else (params, x, e)
    jout, vjp, jstats = jax.vjp(
        (lambda p, x: f(p, x, None)) if e is None else f, *args,
        has_aux=True)
    jg = vjp(jnp.asarray(cot))

    layer.load_state_dict(to_torch(gine_state_dict(params, stats)))
    layer.train(train)
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    te = None if e is None else torch.from_numpy(np.array(e)).requires_grad_()
    out, eo = layer(torch_batch(batch), tx, te)
    assert eo is te
    _close(out, jout, "x")
    names = [n for n, _ in layer.named_parameters()]
    wrt = [tx] + ([] if te is None else [te]) + list(layer.parameters())
    grads = torch.autograd.grad(out, wrt, torch.from_numpy(cot))
    _close(grads[0], jg[1], "dx", True)
    if te is not None:
        _close(grads[1], jg[2], "de", True)
    want = gine_state_dict(jax.device_get(jg[0]), None)
    assert set(want) == set(names)
    for name, g in zip(names, grads[len(wrt) - len(names):]):
        _close(g, want[name], f"d{name}", True)
    if train:
        want_s = gine_state_dict(params, jax.device_get(jstats))
        got_s = layer.state_dict()
        for k in ("norm.running_mean", "norm.running_var"):
            _close(got_s[k], want_s[k], k)


def test_gine_es_fixture():
    """The reference-extracted ``gine_es`` case (one graph of upstream
    GINEConv with the EquivStableLapPE scale), its weights carried as the
    JAX test carries them and through the weight bridge, at the JAX test's
    rtol 1e-4, atol 1e-5."""
    from graphgps_torch.data.graph import GraphBatch
    from graphgps_torch.models.local_gnn import GINELayer
    from graphgps_torch.weights import gine_state_dict, to_torch

    z = np.load(ROOT / "tests/fixtures/reference_fixtures.npz",
                allow_pickle=True)
    case = z["gine_es"].item()
    st = case["state"]

    def dense(prefix):
        return {"kernel": np.asarray(st[f"{prefix}.weight"]).T,
                "bias": np.asarray(st[f"{prefix}.bias"])}

    params = {"eps": np.asarray(st["eps"]).reshape(()),
              "MLP_0": {"Dense_0": dense("mlp_r_ij.0"),
                        "Dense_1": dense("mlp_r_ij.2")},
              "MLP_1": {"Dense_0": dense("nn.0"), "Dense_1": dense("nn.2")}}
    layer = GINELayer(16, equivstable_pe=True).eval()
    layer.load_state_dict(to_torch(gine_state_dict(params, None)))
    x = torch.from_numpy(np.asarray(case["x"], np.float32))
    ei = torch.from_numpy(np.asarray(case["edge_index"])).int()
    n, m = x.shape[0], ei.shape[1]
    batch = GraphBatch(
        node_feat=x, edge_feat=None, senders=ei[0], receivers=ei[1],
        node_mask=torch.ones(n, dtype=torch.bool),
        edge_mask=torch.ones(m, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool), y=None,
        pe={"pe_EquivStableLapPE": torch.from_numpy(
            np.asarray(case["pe"], np.float32))},
        num_graphs=1, max_nodes=n, edge_block=m)
    with torch.no_grad():
        out, _ = layer(batch, x, torch.from_numpy(
            np.asarray(case["e"], np.float32)))
    np.testing.assert_allclose(out.numpy(), case["out_x"], rtol=1e-4,
                               atol=1e-5)


def test_blocked_rung_matches_jax(monkeypatch):
    """GINE's sums in the loader's layout take JAX's blocked rung: per-graph
    one-hot products, no ``index_add_``. ``segment_sum`` with the edge mask
    and ``gather``, forward and backward, against JAX's ``segment_sum`` and
    ``gather`` with the same ``edge_block`` and ``max_nodes`` (the gather's
    forward exact)."""
    from graphgps_tpu.ops import segment as jseg
    from graphgps_torch.ops import segment

    def no_index_add(*a):
        raise AssertionError("index_add_ taken in the blocked layout")

    monkeypatch.setattr(segment, "_index_add", no_index_add)
    batch, x, *_ = _blocked_batch(3, 40, 96, 64, seed=9)
    tb = torch_batch(batch)
    kw = dict(edge_block=batch.edge_block, max_nodes=batch.max_nodes)
    S, E = tb.num_node_slots, tb.senders.shape[0]
    assert segment.segment_rung((E, 64), True, S, "cuda", **kw) == "blocked"
    rng = np.random.default_rng(10)
    data = rng.standard_normal((E, 64)).astype(np.float32)
    cot = rng.standard_normal((S, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jseg.segment_sum(
        d, batch.receivers, S, mask=batch.edge_mask, **kw), jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_()
    got = segment.segment_sum(td, tb.receivers, S, mask=tb.edge_mask, **kw)
    _close(got, want, "segment_sum", tol=1e-5)
    g, = torch.autograd.grad(got, td, torch.from_numpy(cot))
    _close(g, vjp(jnp.asarray(cot))[0], "segment_sum backward", True, 1e-5)
    gcot = rng.standard_normal((E, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jseg.gather(v, batch.senders, **kw), x)
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    got = segment.gather(tx, tb.senders, **kw)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g, = torch.autograd.grad(got, tx, torch.from_numpy(gcot))
    _close(g, vjp(jnp.asarray(gcot))[0], "gather backward", True, 1e-5)


# ---------------------------------------------------------------------------
# the encoders

def zinc_loaders(*extra, cfg_path=ZINC_CFG, small=ZINC_SMALL):
    """(jcfg, jsplits, JAX DeviceLoaders, tcfg, tsplits, port loaders) of a
    ZINC recipe cut to test size: JAX's device loaders built directly at
    the port's caps, so both hold the same batches (JAX's driver collates
    the LapPE recipes on the host)."""
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.data.device_loader import DeviceLoader as JaxLoader
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, cfg_path=cfg_path, small=small)
    jsplits, tsplits = jload(jcfg), load_dataset(tcfg)
    tl = create_loaders(tcfg, tsplits, "cpu")
    ref = tl["train"]
    jl = {name: JaxLoader(getattr(jsplits, name), ref.batch_size,
                          max_nodes=ref.max_nodes,
                          max_edges=ref.batch_size * ref.arenas.edge_cap,
                          shuffle=(name == "train"), seed=jcfg.seed)
          for name in tl}
    return jcfg, jsplits, jl, tcfg, tsplits, tl


class _Holder(torch.nn.Module):
    """The port's encoder under the name the weight bridge gives it."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder


def _fixed_signs(monkeypatch):
    """Both packages' LapPE sign flips fixed to SIGNS (1 keep, 0 flip)."""
    from graphgps_torch.models import encoders

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(SIGNS > 0))
    monkeypatch.setattr(encoders, "draw_signs",
                        lambda gen, K: torch.from_numpy(SIGNS * 2.0 - 1.0)
                        .float())


@pytest.mark.parametrize("cfg_path,names", [
    (ZINC_CFG, ["type_dict", "rwse"]),
    (ZINC_LAPPE_CFG, ["type_dict", "lap"]),
    (ZINC_BOTH_CFG, ["type_dict", "lap", "rwse"])])
def test_feature_encoder_matches_jax(monkeypatch, cfg_path, names):
    """``FeatureEncoder`` for ``TypeDictNode+RWSE``, ``+LapPE`` and
    ``+LapPE+RWSE`` with ``TypeDictEdge`` in training on the first train
    batch: the node width split as JAX splits it (the dataset encoder at
    d − Σ dim_pe, each encoding appended in the name's order), x and e,
    every parameter's gradient under random cotangents, and the RWSE
    norm's running statistics."""
    from graphgps_tpu.config.config import FrozenCfg
    from graphgps_tpu.models.networks import FeatureEncoder as JaxEncoder
    from graphgps_torch.models.encoders import FeatureEncoder

    _fixed_signs(monkeypatch)
    jcfg, _, jl, tcfg, _, tl = zinc_loaders(cfg_path=cfg_path)
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    d = tcfg.gt.dim_hidden
    jenc = JaxEncoder(cfg=FrozenCfg(jcfg), dim_h=d)
    key = jax.random.PRNGKey(4)
    var = jenc.init({"params": key, "signflip": key}, jb, False)
    # the running statistics as initialised (mean 0): random ones far from
    # the batch means make the single-pass variance of both packages cancel
    # in f32 on RWSE's constant columns (``test_torch_kstep.py``
    # ``_calibrated_stats``)
    params, _ = randomize_norms(var["params"], {}, seed=5)
    stats = jax.device_get(var.get("batch_stats", {}))
    rng = np.random.default_rng(6)
    cx = rng.standard_normal((tb.num_node_slots, d)).astype(np.float32)
    ce = rng.standard_normal((tb.senders.shape[0], d)).astype(np.float32)

    def f(p):
        (x, e), mut = jenc.apply({"params": p, "batch_stats": stats}, jb,
                                 True, mutable=["batch_stats"],
                                 rngs={"signflip": key})
        return (x, e), mut.get("batch_stats", {})

    (jx, je), vjp, jstats = jax.vjp(f, params, has_aux=True)
    jg, = vjp((jnp.asarray(cx), jnp.asarray(ce)))

    enc = FeatureEncoder(tcfg, d)
    assert enc.node_name == "type_dict" and enc.edge_name == "edge_type_dict"
    assert [enc.node_name] + enc.pe_names == names
    pe_width = sum(tcfg[f"posenc_{p}"].dim_pe
                   for p in tcfg.dataset.node_encoder_name.split("+")[1:])
    assert enc.type_dict.embedding.embedding_dim == d - pe_width
    holder = _Holder(enc)
    sd = state_dict_from_flax_encoder(params, stats)
    missing, unexpected = holder.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    holder.train()
    x, e = enc(tb, torch.Generator())
    _close(x, jx, "x")
    _close(e, je, "e")
    names_p = [n for n, _ in holder.named_parameters()]
    grads = torch.autograd.grad((x, e), list(holder.parameters()),
                                (torch.from_numpy(cx), torch.from_numpy(ce)))
    want = state_dict_from_flax_encoder(jax.device_get(jg), None)
    assert set(want) == set(names_p)
    for n, g in zip(names_p, grads):
        _close(g, want[n], f"d{n}", True)
    got_s = holder.state_dict()
    want_s = state_dict_from_flax_encoder(params, jax.device_get(jstats))
    running = [k for k in want_s if k.endswith(("running_mean",
                                                "running_var"))]
    assert len(running) == (2 if "rwse" in names else 0)
    for k in running:
        _close(got_s[k], want_s[k], k)


def state_dict_from_flax_encoder(params, stats):
    """The port's ``encoder.*`` state dict of a flax FeatureEncoder's
    trees, through the weight bridge."""
    from graphgps_torch.weights import _encoder_state_dict, to_torch

    out = {}
    _encoder_state_dict(out, params, stats)
    return to_torch(out)


# ---------------------------------------------------------------------------
# the GINE+Transformer layer and the model

def _jax_gine_layer(d, dropout, attn_dropout):
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer

    return JaxGPSLayer(dim_h=d, local_gnn_type="GINE",
                       global_model_type="Transformer", num_heads=4,
                       batch_norm=True, act="relu", dropout=dropout,
                       attn_dropout=attn_dropout)


@pytest.mark.parametrize("d,dropout,train", [
    (64, 0.0, True), (64, DROP, True), (32, 0.0, True), (64, 0.0, False)])
def test_gine_gps_layer_matches_jax(monkeypatch, d, dropout, train):
    """One GINE+Transformer layer with BatchNorm on 3 graphs of up to 40
    node slots, attention dropout 0.5 (the dense rung on both sides): the
    output, the gradients of x, e and every parameter under a random
    cotangent, and in training the updated running statistics of its three
    norms. Dropout 0 (published) and 0.2 (both drop-adds and the FFN
    through the kernels' plain versions) at d = 64; at zinc-debug's d = 32
    JAX's plain FFN and adds."""
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    patches = Patches(monkeypatch, d)
    batch, x, e, *_ = _blocked_batch(3, 40, 96, d, seed=6)
    jl = _jax_gine_layer(d, dropout, ATTN_DROP)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"],
                                    seed=4)
    params["GINELayer_0"]["eps"] = np.float32(0.2)
    cot = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x,
                            e, train, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return out[0], mut.get("batch_stats", {})

    jxo, vjp, jstats = jax.vjp(f, params, x, e, has_aux=True)
    jgp, jgx, jge = vjp(jnp.asarray(cot))
    assert patches.bits_calls == (3 if train and dropout else 0)
    assert (patches.attn_calls >= 1) == train

    layer = GPSLayer(d, 4, act="relu", dropout=dropout,
                     attn_dropout=ATTN_DROP, local="GINE").train(train)
    assert layer.plain_local
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    te = torch.from_numpy(np.array(e)).requires_grad_()
    txo, teo = layer(torch_batch(batch), tx, te,
                     torch.Generator().manual_seed(0))
    assert teo is te
    _close(txo, jxo, "x")
    assert (txo.detach().numpy()[~np.asarray(batch.node_mask)] == 0).all()
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(txo, [tx, te, *layer.parameters()],
                                torch.from_numpy(cot))
    _close(grads[0], jgx, "dx", True)
    _close(grads[1], jge, "de", True)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[2:]):
        _close(g, want_g[name], f"d{name}", True)
    if train:
        want_s = gps_layer_state_dict(params, jax.device_get(jstats))
        got_s = layer.state_dict()
        running = [k for k in want_s
                   if k.endswith(("running_mean", "running_var"))]
        assert len(running) == 6
        for k in running:
            _close(got_s[k], want_s[k], k)


def test_narrow_gine_layer_seeds_reach_their_sites(monkeypatch):
    """At zinc-debug's width of 32 (below the tail kernels' envelope) a
    GINE+Transformer layer in training with dropout 0.2 drops on all four
    of its sites, flax ``nn.Dropout``'s exact rate on the two residuals and
    the FFN, as JAX's plain path: each of the four seeds moves the output."""
    from graphgps_torch.models import gps_layer

    batch, x, e, *_ = _blocked_batch(3, 40, 96, 32, seed=2)
    tb = torch_batch(batch)
    xt, et = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(e))
    layer = gps_layer.GPSLayer(32, 4, dropout=DROP, attn_dropout=ATTN_DROP,
                               local="GINE", batch_norm=False).train()
    seeds0 = [1111111, 222222222, 33333, 2 ** 31 - 5]

    def run(seeds):
        monkeypatch.setattr(gps_layer, "draw_seeds", lambda gen, n: seeds[:n])
        with torch.no_grad():
            return layer(tb, xt, et)[0]

    base = run(seeds0)
    assert torch.equal(base, run(seeds0))
    for i in range(4):
        seeds = list(seeds0)
        seeds[i] += 1
        assert not torch.equal(run(seeds), base), i


def test_zinc_train_step_matches_jax(monkeypatch):
    """One whole train step of zinc-GPS+RWSE at 2 x 64 (attention dropout
    0.5 on the dense rung, L1 over the real graphs, adamW, clipping, lr
    1e-3 with no schedule) on the first train batch: loss, clipped
    gradients by the port's names, updated parameters and running
    statistics, from randomised norms with the running statistics
    calibrated on the split (``test_torch_kstep.py``)."""
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_kstep import _calibrated_stats
    from tests.test_torch_train import _clip

    lr = 1e-3
    patches = Patches(monkeypatch, 64)
    jcfg, _, jl, tcfg, tsplits, tl = zinc_loaders(
        "optim.base_lr", str(lr), "optim.scheduler", "none")
    dim_out = infer_dims(tcfg, tsplits)
    assert dim_out == 1
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key}, jb, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"],
                                    seed=9)
    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    loader = tl["train"]
    sel = np.arange(loader.arenas.num_graphs_total).reshape(
        -1, 1, loader.batch_size)
    stats = _calibrated_stats(model, loader, sel, params, stats)
    load_flax(model, params, stats)

    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    (jloss, _), jg = jax.value_and_grad(raw["forward"], has_aux=True)(
        state.params, state.batch_stats, jb, rng, jnp.asarray(0))
    state, jloss2, *_ = raw["train"](state, jb, rng)
    assert patches.bits_calls == 0 and patches.attn_calls >= 2

    opt = build_optimizer(tcfg, model.parameters())
    named = dict(model.named_parameters())
    init = {k: v.detach().clone() for k, v in named.items()}
    loss, pred, _, mask = train_step(tcfg, model, opt, tb,
                                     torch.Generator().manual_seed(0))
    assert pred.shape == (8, 1) and torch.equal(mask, tb.graph_mask)
    assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats)).items()}
    assert set(want_g) == set(named)
    moved = 0.0
    for k, g in want_g.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), g, rtol=RTOL,
            atol=ATOL * max(1e-3, np.abs(g).max()), err_msg=f"grad {k}")
        noisy = np.abs(g) < 1e-7
        tol = np.where(noisy, 2 * lr, 1e-5 + 1e-5 * np.abs(new[k])
                       + 1e-2 * lr)
        diff = np.abs(named[k].detach().numpy() - new[k])
        assert (diff <= tol).all(), (k, float(diff.max()))
        moved = max(moved, float(np.abs(new[k] - init[k].numpy())[~noisy]
                                 .max(initial=0.0)))
    assert moved > 0.5 * lr
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the family through the entry point

# the six configs of the family that build, and those that still refuse
FAMILY = ["GPS/zinc-GPS+RWSE", "GPS/zinc-GPS+RWSE-ckptbest", "GPS/zinc-GPS",
          "GPS/zinc-GPS-LapPE+RWSE", "debug/zinc-debug", "SAN/zinc-SAN"]
REFUSED = [("GPS/zinc-GPS+RWSE-inference", "item 17"),
           ("GPS/zinc-GPS+SNDS", "item 16"), ("GPS/zinc-GPS+SNMLP", "item 16"),
           ("GPS/zinc-GPS-ESLapPE", "item 16"),
           ("GPS/zinc-GPSwGraphormer", "item 15"),
           ("GPS/zinc-GPSwGraphormer+VN", "item 15")]
FAMILY_SMALL = ["gt.layers", "2", "train.batch_size", "8",
                "dataset.synth_num_graphs", "40", "optim.max_epoch", "1",
                "optim.num_warmup_epochs", "1"]


@pytest.mark.parametrize("name", FAMILY)
def test_zinc_family_trains_one_epoch(tmp_path, caplog, name):
    """Each config of the family at 2 layers on 40 stand-in graphs through
    ``driver.main`` in ``train.mode custom``: one train, val and test line
    with a finite loss and ``mae``. zinc-GPS+RWSE (which sets
    ``train.steps_per_dispatch: 32``) takes K steps per dispatch (4 real
    batches in a group of 32); zinc-GPS, given K = 32, keeps one step per
    dispatch with JAX's warning (LapPE's eigenvalues are host-collated
    extras)."""
    from graphgps_torch.driver import main

    extra = ["train.steps_per_dispatch", "32"] if name == "GPS/zinc-GPS" \
        else []
    cfg = str(ROOT / "configs" / f"{name}.yaml")
    with caplog.at_level(logging.INFO, logger="graphgps_torch"):
        hist = main(["--device", "cpu", "--cfg", cfg, *FAMILY_SMALL,
                     "train.mode", "custom", *extra, "out_dir",
                     str(tmp_path)])[0]
    assert {k: [r["epoch"] for r in v] for k, v in hist.items()} == {
        "train": [0], "val": [0], "test": [0]}
    for rows in hist.values():
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["mae"])
                   for r in rows)
    text = caplog.text
    warned = "steps_per_dispatch>1 needs a DeviceLoader" in text
    assert warned == (name == "GPS/zinc-GPS")
    k_steps = "4 steps in 1 dispatches of K=32" in text
    assert k_steps == (name == "GPS/zinc-GPS+RWSE")
    run = tmp_path / os.path.basename(name) / "0"
    assert (run / "train" / "stats.json").exists()


@pytest.mark.parametrize("name,item", REFUSED)
def test_zinc_family_refusals(tmp_path, name, item):
    """The family's configs that still refuse, each naming its ROADMAP
    item: a pretrained checkpoint (17), SignNet and EquivStableLapPE (16),
    GINE+BiasedTransformer (15)."""
    from graphgps_torch.driver import main

    cfg = str(ROOT / "configs" / f"{name}.yaml")
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        main(["--device", "cpu", "--cfg", cfg, *FAMILY_SMALL, "out_dir",
              str(tmp_path)])
