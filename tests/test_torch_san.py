"""What the ogbg-molhiv SAN recipe (``configs/SAN/ogbg-molhiv-SAN.yaml``:
``Atom+LapPE`` with LapPE's Transformer form and ``Bond``, 10 x 64 SAN layers
with 4 heads over the real and the complement graph, ``san_graph`` head over
``add`` pooling, BCE, ``auc``, adam under ``reduce_on_plateau``) brings to
the port, against the JAX package on the CPU: the SAN attention on directed
edges, the SAN layer on the ``fused_bn_ffn`` kernel's route and on the plain
one, the LapPE Transformer encoder, add pooling with the SAN head, the
reference-extracted fixtures ``san_full``, ``san_block``, ``lappe_deepset``
and ``lappe_train_bn``, the plateau scheduler, the recipe cut to 2 layers in
evaluation and for a whole train step, the refusals, and the entry point
with its checkpoints and ``train.auto_resume``.

Dropout. The port's masks go to both packages, patched from here with
nothing changed in either (``Patches``): JAX's ``jax.random.bernoulli`` (in
flax's order: LapPE's sign flip, then per LapPE layer flax ``nn.Dropout``'s
four sites, then per SAN layer the attention output's), ``jax.random.bits``
(the kernel's seed) and ``fused_combine._keep`` (the kernel's inner site over
its true width), and the port's ``draw_signs`` and ``draw_seeds``. Each patch
counts its calls, so a JAX path that took another route fails the test.

The JAX driver collates an ``Atom+LapPE`` recipe on the host; the tests
build the JAX ``DeviceLoader`` directly (as the VOC tests do), which lays the
same arrays out per graph.

Tolerances, f32: the fixtures rtol 1e-4 and atol 1e-5 as
``tests/test_reference_fixtures.py`` holds JAX; the pooling and the head
1e-6; a layer, the encoder and the model rtol = atol = 1e-4 (a gradient's
atol scaled by its tensor's largest entry)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import small_cfgs
from tests.test_torch_layer import randomize_norms, torch_batch
from tests.test_torch_main import ROOT
from tests.test_torch_tasks import _run_cli, _stats
from tests.test_torch_unmerged import keep_at

torch.set_num_threads(2)

SAN_CFG = str(ROOT / "configs/SAN/ogbg-molhiv-SAN.yaml")
# the recipe (d = 64, 4 heads, LapPE Transformer of 3 layers) cut to 2 SAN
# layers; 40 graphs of up to 14 nodes in batches of 8: train 32 (4 batches),
# val and test 4 (one half-filled batch each); 14 node slots, R = 112 rows
SAN_SMALL = ["gt.layers", "2", "train.batch_size", "8",
             "dataset.synth_num_graphs", "40", "dataset.synth_max_nodes",
             "14"]
RTOL = ATOL = 1e-4
SIGNS = np.array([1, 0, 0, 1, 1, 1, 0, 1, 0, 0])   # 1: keep, 0: flip
# per SAN layer: the attention output's, the kernel's; per LapPE layer
SAN_SEEDS = [1234567, 7654321]
LAPPE_SEEDS = [111, 2 ** 31 - 5, 424242]


class Patches:
    """The port's masks in both packages (see the module docstring).
    ``order`` lists what each ``bernoulli`` call answers, in flax's order:
    "signs" or a (seed, site) of the port's ``exact_dropout``; ``width`` is
    the kernel's inner site's true width."""

    def __init__(self, monkeypatch, order, width=128):
        from graphgps_tpu.ops.pallas import fused_combine
        from graphgps_torch.models import encoders, san
        from graphgps_torch.ops.kernels.common import drop_bits

        self.order = list(order)
        self.bernoulli = self.bits = self.signs = 0
        self.seeds = {"lappe": 0, "san": 0}
        self.keep = keep_at({1: width})
        real_bits = jax.random.bits

        def bits(key, shape=(), dtype=None):
            if tuple(shape) != ():
                return real_bits(key, shape, dtype)
            self.bits += 1
            return jnp.asarray(SAN_SEEDS[1], jnp.uint32)

        def bernoulli(key, p=0.5, shape=None):
            what = self.order[self.bernoulli % len(self.order)]
            self.bernoulli += 1
            if what == "signs":
                assert tuple(shape) == SIGNS.shape
                return jnp.asarray(SIGNS > 0)
            seed, site = what
            b = drop_bits(seed, site, int(np.prod(shape[:-1])), shape[-1])
            u = (b >> 8).to(torch.float32) * 2.0 ** -24
            return jnp.asarray((u < p).numpy().reshape(shape))

        def draw_signs(gen, K):
            self.signs += 1
            return torch.from_numpy(SIGNS * 2.0 - 1.0).float()

        def seeds(name, values):
            def draw(gen, n):
                self.seeds[name] += 1
                assert n == len(values)
                return list(values)
            return draw

        monkeypatch.setattr(fused_combine, "_keep", self.keep)
        monkeypatch.setattr(jax.random, "bits", bits)
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        monkeypatch.setattr(encoders, "draw_signs", draw_signs)
        monkeypatch.setattr(encoders, "draw_seeds",
                            seeds("lappe", LAPPE_SEEDS))
        monkeypatch.setattr(san, "draw_seeds", seeds("san", SAN_SEEDS))


def lappe_order(layers: int):
    """flax's draws in a LapPE Transformer in training: the signs, then four
    sites per layer."""
    return ["signs"] + [(LAPPE_SEEDS[li], s) for li in range(layers)
                        for s in range(4)]


def _close(got, want, msg, rtol=RTOL, atol=ATOL, scaled=True):
    want = np.asarray(want)
    if scaled:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=atol, err_msg=msg)


def san_loaders(*extra):
    """(jcfg, jsplits, JAX device loaders, tcfg, tsplits, port loaders) of
    the recipe at SAN_SMALL."""
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.data.device_loader import DeviceLoader as JaxLoader
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, cfg_path=SAN_CFG, small=SAN_SMALL)
    jsplits, tsplits = jload(jcfg), load_dataset(tcfg)
    tl = create_loaders(tcfg, tsplits, "cpu")
    ref = tl["train"]
    jl = {name: JaxLoader(getattr(jsplits, name), ref.batch_size,
                          max_nodes=ref.max_nodes,
                          max_edges=ref.batch_size * ref.arenas.edge_cap,
                          shuffle=(name == "train"), seed=jcfg.seed,
                          y_graph_level=True)
          for name in tl}
    return jcfg, jsplits, jl, tcfg, tsplits, tl


@pytest.fixture(scope="module")
def loaders():
    return san_loaders()


# ---------------------------------------------------------------------------
# the attention and the layer

def _directed_batch(B=4, N=16, E=40, d=64, seed=0):
    """A padded batch of random directed graphs (multi-edges, self loops)
    as JAX and port batches, with x (B·N, d) and e (B·E, d)."""
    from tests.test_fused_gatedgcn import _blocked_batch

    jb, x, e, *_ = _blocked_batch(B, N, E, d, seed=seed)
    return jb, torch_batch(jb), np.array(x), np.array(e)


def test_dense_adjacency_matches_jax():
    from graphgps_tpu.models.san import dense_adjacency as jadj
    from graphgps_torch.models.san import dense_adjacency

    jb, tb, *_ = _directed_batch(seed=3)
    want = np.asarray(jadj(jb))
    got = dense_adjacency(tb).numpy()
    # the padded edges sit on node 0's self pair, which the layer masks
    eye = np.eye(jb.max_nodes, dtype=bool)[None]
    np.testing.assert_array_equal(got & ~eye, want & ~eye)
    assert not np.array_equal(want, want.transpose(0, 2, 1))


@pytest.mark.parametrize("full_graph", [True, False])
def test_san_attention_matches_jax(full_graph):
    """Real and fake edges on directed graphs (the fake mask's transpose
    shows), padded node and edge slots, γ = 0.1: output and the gradients
    of x, e and every projection."""
    from graphgps_tpu.models.san import SANAttention as JaxAttention
    from graphgps_torch.models.san import SANAttention
    from graphgps_torch.weights import san_layer_state_dict, to_torch

    d, H = 64, 4
    jb, tb, x, e = _directed_batch(d=d, seed=4)
    ja = JaxAttention(out_dim=d // H, num_heads=H, gamma=0.1,
                      full_graph=full_graph)
    params = jax.device_get(ja.init(jax.random.PRNGKey(1), jb, x, e,
                                    False)["params"])
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x, e: ja.apply({"params": p}, jb, x, e,
                                                 False), params, x, e)
    jg = vjp(jnp.asarray(cot))

    attn = SANAttention(d, H, 0.1, full_graph)
    sd = san_layer_state_dict({"SANAttention_0": params,
                               **{f"Dense_{i}": {"kernel": 0, "bias": 0}
                                  for i in range(3)}}, None)
    attn.load_state_dict({k[len("attn."):]: v for k, v in to_torch(sd).items()
                          if k.startswith("attn.")})
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, e))
    out = attn(tb, xt, et)
    _close(out, want, "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, jg[1], "dx")
    _close(et.grad, jg[2], "de")
    for name, g in jg[0].items():
        if name == "fake_edge_emb":
            _close(attn.fake_edge_emb.grad, g, name)
        else:
            _close(getattr(attn, f"w_{name.lower()}").grad,
                   np.asarray(g["kernel"]).reshape(d, -1), name)


@pytest.mark.parametrize("route", ["kernel", "plain_eval", "plain_train"])
def test_san_layer_matches_jax(monkeypatch, route):
    """One SAN layer at d = 64 on a padded batch of directed graphs: in
    training at dropout 0.2 the ``fused_bn_ffn`` route (statistics from the
    stats-only norm, the kernel's plain version here, Pallas interpret mode
    in JAX), in evaluation and in training at dropout 0 the plain route.
    Output, the gradients of x, e and every parameter, and the updated
    running statistics."""
    from graphgps_tpu.models.san import SANLayer as JaxSANLayer
    from graphgps_torch.models.san import SANLayer
    from graphgps_torch.ops.kernels import bn_ffn
    from graphgps_torch.weights import san_layer_state_dict, to_torch

    d, H = 64, 4
    train = route != "plain_eval"
    rate = 0.2 if route == "kernel" else 0.0
    patches = Patches(monkeypatch, [(SAN_SEEDS[0], 0)], width=2 * d)
    jb, tb, x, e = _directed_batch(d=d, seed=6)
    jl = JaxSANLayer(dim_h=d, num_heads=H, gamma=0.1, dropout=rate)
    var = jl.init(jax.random.PRNGKey(2), jb, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=8)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def f(p, x, e):
        (out, _), mut = jl.apply({"params": p, "batch_stats": stats}, jb, x,
                                 e, train,
                                 rngs={"dropout": jax.random.PRNGKey(3)},
                                 mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, vjp, new_stats = jax.vjp(f, params, x, e, has_aux=True)
    jg = vjp(jnp.asarray(cot))
    kernel = route == "kernel"
    assert patches.keep.calls == (2 if kernel else 0)
    assert patches.bits == int(kernel) and patches.bernoulli == int(kernel)

    layer = SANLayer(d, H, gamma=0.1, dropout=rate).train(train)
    layer.load_state_dict(to_torch(san_layer_state_dict(params, stats)))
    assert layer.fused(x.shape[0]) == kernel
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, e))
    before = bn_ffn.fused_bn_ffn.launches
    out, _ = layer(tb, xt, et, torch.Generator())
    assert patches.seeds["san"] == int(kernel)
    assert bn_ffn.fused_bn_ffn.launches == before   # the CPU's plain version
    _close(out, want, "out")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, jg[1], "dx")
    _close(et.grad, jg[2], "de")
    want_g = to_torch(san_layer_state_dict(jg[0], None))
    named = dict(layer.named_parameters())
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        _close(named[k].grad, g.numpy(), k)
    new = to_torch(san_layer_state_dict(params, jax.device_get(new_stats)))
    sd = layer.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], v.numpy(), k)


def test_san_param_tree_same_on_both_routes(loaders):
    """The kernel route creates ``Dense_1``/``Dense_2``/``Norm_0`` in another
    order than the plain route: JAX's SANTransformer has the same parameter
    tree (names and shapes) built in training and in evaluation."""
    from graphgps_tpu.models.networks import build_model as jbuild

    jcfg, _, jl, *_ = loaders
    _, jb = next(iter(jl["val"]))   # an epoch of train would reshuffle
    jmodel = jbuild(jcfg, 1)
    keys = {"params": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1),
            "signflip": jax.random.PRNGKey(2)}
    shapes = [jax.tree_util.tree_map(np.shape, jax.eval_shape(
        lambda: jmodel.init(keys, jb, train))) for train in (False, True)]
    assert shapes[0] == shapes[1]
    layer = shapes[0]["params"]["SANLayer_0"]
    assert set(layer) == {"SANAttention_0", "Dense_0", "Dense_1", "Dense_2",
                          "Norm_0", "Norm_1"}
    assert layer["Dense_1"]["kernel"] == (64, 128)


# ---------------------------------------------------------------------------
# encoders, pooling, head

@pytest.mark.parametrize("train", [False, True])
def test_lappe_transformer_encoder_matches_jax(monkeypatch, loaders, train):
    """The FeatureEncoder (``Atom+LapPE`` with the 3-layer LapPE Transformer,
    ``Bond``) on a half-filled batch: x and e, in evaluation and in training
    (the sign flip, dropout 0.1 on the four sites of every layer; padded
    node slots have no real frequency and softmax uniformly)."""
    from graphgps_tpu.config.config import FrozenCfg
    from graphgps_tpu.models.networks import FeatureEncoder as JaxEncoder
    from graphgps_torch.models.encoders import FeatureEncoder
    from graphgps_torch.weights import _encoder_state_dict, to_torch

    patches = Patches(monkeypatch, lappe_order(3))
    jcfg, _, jl, tcfg, _, tl = loaders
    _, jb = next(iter(jl["val"]))
    _, tb = next(iter(tl["val"]))
    assert not tb.node_mask.all() and not tb.graph_mask.all()
    jenc = JaxEncoder(cfg=FrozenCfg(jcfg), dim_h=64)
    key = jax.random.PRNGKey(1)
    var = jenc.init({"params": key, "signflip": key}, jb, False)
    params = jax.device_get(var["params"])
    (jx, je) = jenc.apply({"params": params}, jb, train,
                          rngs={"signflip": key, "dropout": key})
    assert patches.bernoulli == (13 if train else 0)

    enc = FeatureEncoder(tcfg, 64).train(train)
    sd = {}
    _encoder_state_dict(sd, params, None)
    missing, unexpected = enc.load_state_dict(
        {k[len("encoder."):]: v for k, v in to_torch(sd).items()},
        strict=False)
    # JAX makes one table per feature column of the data (the stand-in has one)
    assert not unexpected and all(
        k.startswith(("atom.", "bond.")) for k in missing)
    assert enc.lap.transformer[0].ffn1.out_features == 2048
    with torch.no_grad():
        tx, te = enc(tb, torch.Generator())
    assert (patches.signs, patches.seeds["lappe"]) == (int(train),) * 2
    _close(tx, jx, "x")
    _close(te, je, "e")
    assert torch.isfinite(tx).all() and (tx[~tb.node_mask] == 0).all()


def test_add_pool_and_san_head_match_jax():
    """``global_add_pool`` and the san_graph head (two halving Linears with
    relu, then the output) on a padded batch."""
    from graphgps_tpu.models.heads import SANGraphHead as JaxHead
    from graphgps_tpu.models.heads import global_add_pool as jpool
    from graphgps_torch.models.heads import SANGraphHead, global_add_pool
    from graphgps_torch.weights import _linear, to_torch

    jb, tb, x, _ = _directed_batch(d=64, seed=11)
    x = x * np.asarray(jb.node_mask)[:, None]
    want = np.asarray(jpool(jnp.asarray(x), jb))
    got = global_add_pool(torch.from_numpy(x), tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    jh = JaxHead(dim_in=64, dim_out=1, pooling="add")
    params = jax.device_get(jh.init(jax.random.PRNGKey(4), jb,
                                    jnp.asarray(x), False)["params"])
    want, _ = jh.apply({"params": params}, jb, jnp.asarray(x), False)
    head = SANGraphHead(64, 1, pooling="add")
    sd = {}
    for i in range(2):
        _linear(sd, f"hidden.{i}", params[f"Dense_{i}"])
    _linear(sd, "out", params["Dense_2"])
    head.load_state_dict(to_torch(sd))
    with torch.no_grad():
        got, _ = head(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# reference-extracted fixtures

@pytest.fixture(scope="module")
def fixtures():
    z = np.load(ROOT / "tests/fixtures/reference_fixtures.npz",
                allow_pickle=True)
    return {k: z[k].item() for k in z.files}


def _fixture_batch(case, d=16, pe=None):
    """The port's batch of a two-graph fixture: graph g on slots
    [g·N, g·N + n_g)."""
    from graphgps_torch.data.graph import GraphBatch

    n1, n2 = case["graph_sizes"]
    nmax = int(max(n1, n2))
    slot_of = np.concatenate([np.arange(n1), nmax + np.arange(n2)])
    x = np.zeros((2 * nmax, d), np.float32)
    x[slot_of] = case["x"]
    mask = np.zeros(2 * nmax, bool)
    mask[slot_of] = True
    ei = torch.from_numpy(slot_of[case["edge_index"]].astype(np.int32))
    m = ei.shape[1]
    tb = GraphBatch(
        node_feat=torch.from_numpy(x), edge_feat=None, senders=ei[0],
        receivers=ei[1], node_mask=torch.from_numpy(mask),
        edge_mask=torch.ones(m, dtype=torch.bool),
        graph_mask=torch.ones(2, dtype=torch.bool), y=None, pe={},
        num_graphs=2, max_nodes=nmax, edge_block=m)
    return tb, torch.from_numpy(x), slot_of


def _fixture_attn(attn, st, prefix=""):
    with torch.no_grad():
        for ours, theirs in (("q", "Q"), ("k", "K"), ("v", "V"), ("e", "E"),
                             ("q2", "Q_2"), ("k2", "K_2"), ("e2", "E_2")):
            getattr(attn, f"w_{ours}").copy_(torch.from_numpy(
                np.asarray(st[f"{prefix}{theirs}.weight"]).T))
        attn.fake_edge_emb.copy_(torch.from_numpy(
            np.asarray(st["fake_edge_emb.weight"][0])))


def test_san_attention_matches_reference(fixtures):
    """``san_full``: two graphs with directed edges, γ = 0.1."""
    from graphgps_torch.models.san import SANAttention

    case = fixtures["san_full"]
    tb, x, slot_of = _fixture_batch(case)
    attn = SANAttention(16, 2, 0.1, True)
    _fixture_attn(attn, case["state"])
    with torch.no_grad():
        out = attn(tb, x, torch.from_numpy(case["e"]))
    np.testing.assert_allclose(out.numpy()[slot_of], case["out_x"],
                               rtol=1e-4, atol=1e-5)


def test_san_block_matches_reference(fixtures):
    """``san_block``: the whole layer at d = 16 in evaluation (attention, O,
    BatchNorm, FFN, BatchNorm: the plain route)."""
    from graphgps_torch.models.san import SANLayer

    case = fixtures["san_block"]
    st = case["state"]
    tb, x, slot_of = _fixture_batch(case)
    layer = SANLayer(16, 2, gamma=0.1).eval()
    _fixture_attn(layer.attn, st, "attention.")
    with torch.no_grad():
        for ours, theirs in (("o", "O_h"), ("ffn1", "FFN_h_layer1"),
                             ("ffn2", "FFN_h_layer2")):
            getattr(layer, f"w_{ours}").copy_(torch.from_numpy(
                np.asarray(st[f"{theirs}.weight"]).T))
            getattr(layer, f"b_{ours}").copy_(torch.from_numpy(
                np.asarray(st[f"{theirs}.bias"])))
        for ours, theirs in (("norm1", "batch_norm1_h"),
                             ("norm2", "batch_norm2_h")):
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(getattr(layer, ours), k).copy_(torch.from_numpy(
                    np.asarray(st[f"{theirs}.{k}"])))
        out, _ = layer(tb, x, torch.from_numpy(case["e"]))
    np.testing.assert_allclose(out.numpy()[slot_of], case["out_x"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case_name,train", [("lappe_deepset", False),
                                             ("lappe_train_bn", True)])
def test_lappe_matches_reference(monkeypatch, fixtures, case_name, train):
    """LapPE's DeepSet (3 layers, 2 post layers, raw BatchNorm) on one
    graph, in evaluation and in training (batch statistics; the sign flip
    pinned to +1 as the extractor pinned it)."""
    from graphgps_torch.data.graph import GraphBatch
    from graphgps_torch.models import encoders

    case = fixtures[case_name]
    st = case["state"]
    n, K, d_pe = case["evecs"].shape[0], 4, 6
    monkeypatch.setattr(encoders, "draw_signs",
                        lambda gen, K: torch.ones(K))
    tb = GraphBatch(
        node_feat=torch.from_numpy(np.asarray(case["x"])), edge_feat=None,
        senders=torch.zeros(1, dtype=torch.int32),
        receivers=torch.zeros(1, dtype=torch.int32),
        node_mask=torch.ones(n, dtype=torch.bool),
        edge_mask=torch.zeros(1, dtype=torch.bool),
        graph_mask=torch.ones(1, dtype=torch.bool), y=None,
        pe={"EigVecs": torch.from_numpy(np.asarray(case["evecs"]))},
        extras={"EigVals": torch.from_numpy(
            np.asarray(case["evals"])).reshape(1, 1, K)},
        num_graphs=1, max_nodes=n, edge_block=1)
    enc = encoders.LapPENodeEncoder(d_pe, K, layers=3, post_layers=2,
                                    raw_norm_type="BatchNorm").train(train)
    sd = {}
    for ours, theirs in (("pre.0", "linear_A"), ("pre.1", "pe_encoder.1"),
                         ("pre.2", "pe_encoder.3"),
                         ("post.layers.0", "post_mlp.0"),
                         ("post.layers.1", "post_mlp.2")):
        for k in ("weight", "bias"):
            sd[f"{ours}.{k}"] = st[f"{theirs}.{k}"]
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"raw_norm.{k}"] = st[f"raw_norm.{k}"]
    enc.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                         for k, v in sd.items()})
    with torch.no_grad():
        out = enc(tb, None, torch.Generator())
    np.testing.assert_allclose(out.numpy(), case["out_x"][:, 16 - d_pe:],
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the plateau scheduler

@pytest.mark.parametrize("mode_opts,task", [
    ([], "classification_binary"), (["metric_agg", "argmin"],
                                    "classification_binary"),
    ([], "regression")])
def test_reduce_on_plateau_matches_jax(mode_opts, task):
    """The port's ``ReduceLROnPlateau`` against JAX's on a fixed metric
    sequence that crosses the patience several times, reaches ``min_lr``
    and holds improvements smaller than eps (1e-8), in both modes; the mode
    follows ``metric_agg`` and the task; the state round-trips."""
    from graphgps_tpu.optim.optimizers import reduce_on_plateau as jplateau
    from graphgps_torch.optim import ReduceLROnPlateau, build_schedule

    opts = [*mode_opts, "dataset.task_type", task,
            "optim.schedule_patience", "2", "optim.base_lr", "1e-3",
            "optim.min_lr", "1.5e-4", "optim.reduce_factor", "0.5"]
    jcfg, tcfg = small_cfgs(*opts, cfg_path=SAN_CFG, small=SAN_SMALL)
    want, got = jplateau(jcfg), build_schedule(tcfg)
    assert isinstance(got, ReduceLROnPlateau) and got.mode == want.mode
    assert got.mode == ("max" if not mode_opts and task != "regression"
                        else "min")
    sign = 1.0 if got.mode == "max" else -1.0
    seq = [0.5, 0.6, 0.6 + 5e-9, 0.6, 0.59, 0.61, 0.61 + 1e-9, 0.5, 0.5,
           0.7, 0.7, 0.69, 0.68, 0.7 + 2e-9, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
           0.1, 0.1, 0.1, 0.1, 0.9]
    lrs = []
    for m in seq:
        assert got.update(sign * m) == want.update(sign * m)
        assert got.state_dict() == want.state_dict()
        lrs.append(got.lr)
    assert lrs[0] == 1e-3 and min(lrs) == 1.5e-4 and len(set(lrs)) >= 3
    again = build_schedule(tcfg)
    again.load_state_dict(got.state_dict())
    assert again.state_dict() == got.state_dict()


# ---------------------------------------------------------------------------
# the model

def _jax_model(jcfg, jb):
    from graphgps_tpu.models.networks import build_model as jbuild

    jmodel = jbuild(jcfg, 1)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
            "signflip": jax.random.PRNGKey(0)}
    var = jmodel.init(keys, jb, False)
    return jmodel, randomize_norms(var["params"], var["batch_stats"], seed=9)


def test_san_model_eval_matches_jax(loaders):
    """The recipe at 2 layers in evaluation on a full and on a half-filled
    batch: one logit per real graph, targets array for array; every flax
    leaf lands in the port's state dict."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import SANTransformer, build_model
    from graphgps_torch.weights import load_flax

    jcfg, _, jl, tcfg, tsplits, tl = loaders
    assert infer_dims(tcfg, tsplits) == 1
    _, jb = next(iter(jl["val"]))
    jmodel, (params, stats) = _jax_model(jcfg, jb)
    model = build_model(tcfg, 1).eval()
    assert isinstance(model, SANTransformer)
    load_flax(model, params, stats)
    for split in ("val", "train"):
        _, jb = next(iter(jl[split]))
        _, tb = next(iter(tl[split]))
        want, jtrue = jmodel.apply({"params": params, "batch_stats": stats},
                                   jb, False)
        with torch.no_grad():
            got, true = model(tb)
        assert got.shape == (8, 1)
        np.testing.assert_array_equal(true.numpy(), np.asarray(jtrue))
        m = tb.graph_mask.numpy()
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def off_kinks(tcfg, params, flax_stats, tb, margin=1e-5):
    """``params`` with the LapPE FFN's first biases moved by 10·margin at
    every unit that lies within ``margin`` of its relu kink on a real
    (node, frequency) row of ``tb`` in training (the port in f64, with the
    dropout patches in force), until none does."""
    import dataclasses

    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    lap = params["FeatureEncoder_0"]["LapPENodeEncoder_0"]
    real = ~torch.isnan(tb.pe["EigVecs"])
    tb64 = dataclasses.replace(
        tb, pe={k: v.double() for k, v in tb.pe.items()},
        extras={k: v.double() for k, v in tb.extras.items()})
    for _ in range(5):
        model = build_model(tcfg, 1)
        load_flax(model, params, flax_stats)
        model = model.double().train()
        pre = []
        for layer in model.encoder.lap.transformer:
            layer.ffn1.register_forward_hook(
                lambda mod, i, o: pre.append(o.detach()))
        with torch.no_grad():
            model(tb64, torch.Generator())
        near = [(a[real].abs() < margin).any(0).numpy() for a in pre]
        if not any(n.any() for n in near):
            return params
        for li, n in enumerate(near):
            dense = lap[f"Dense_{2 + 3 * li}"]
            dense["bias"] = np.where(n, dense["bias"] + 10 * margin,
                                     dense["bias"]).astype(np.float32)
    raise AssertionError("LapPE FFN units stay near their relu kinks")


# biases that reach the loss only through a BatchNorm in training, which
# takes any constant shift out: their gradients are 0 in exact arithmetic
ZERO_GRAD = (".b_o", ".b_ffn2")


def test_san_train_step_matches_jax(monkeypatch):
    """One whole train step of the recipe at 2 x 64 (dropout 0.01: each SAN
    layer's FFN through ``fused_bn_ffn``, the plain version here and Pallas
    interpret mode in JAX; the LapPE Transformer's dropout 0.1 and sign flip;
    BCE over the real graphs; adam at 1e-4) on the first training batch:
    loss, every gradient by the port's names, the updated parameters and
    running statistics. The gradients of ``ZERO_GRAD`` are rounding noise
    in both packages: each side is held below 1e-6 of the model's largest
    gradient, and their parameters' adam steps may part by 2 lr.

    A relu's derivative jumps at 0. The LapPE FFN has 2,048 units on each of
    the batch's ~1,000 real (node, frequency) rows; a unit within f32
    rounding of its kink may take either side in either package (or in JAX
    with and without ``jit``) and move that FFN's bias gradient by ~2%. So
    the weights are first moved off the kinks (``off_kinks``), and the test
    compares the gradient where it is smooth."""
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax

    jcfg, _, jl, tcfg, _, tl = san_loaders()
    lr = tcfg.optim.base_lr
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, jb)
    order = lappe_order(3) + [(SAN_SEEDS[0], 0)] * tcfg.gt.layers
    patches = Patches(monkeypatch, order)
    params = off_kinks(tcfg, params, stats, tb)
    patches.signs, patches.seeds = 0, {"lappe": 0, "san": 0}
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(raw["forward"], has_aux=True))(
        state.params, state.batch_stats, jb, rng, jnp.asarray(0))
    state, jloss2, *_ = jax.jit(raw["train"])(state, jb, rng)
    # two traces: per trace the encoder's 13 draws and one per SAN layer,
    # the kernel's seed per layer and its inner site forward and backward
    assert patches.bernoulli == 2 * len(order)
    assert patches.bits == 2 * tcfg.gt.layers
    assert patches.keep.calls == 2 * patches.bits

    model = build_model(tcfg, 1).train()
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    named = dict(model.named_parameters())
    loss, pred, _, mask = train_step(tcfg, model, opt, tb, torch.Generator())
    assert patches.seeds == {"lappe": 1, "san": tcfg.gt.layers}
    assert pred.shape == (8, 1) and torch.equal(mask, tb.graph_mask)
    assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    want_g = {k: v.numpy() for k, v in
              state_dict_from_flax(jax.device_get(jg)).items()}
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats)).items()}
    # JAX makes one table per feature column of the data (the stand-in has
    # one); the port's unused tables get zero gradients
    assert set(want_g) <= set(named) and all(
        k.startswith(("encoder.atom.", "encoder.bond."))
        for k in set(named) - set(want_g))
    top = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in want_g.items():
        got = named[k].grad.numpy()
        if k.endswith(ZERO_GRAD):
            # rounding noise on both sides
            assert max(np.abs(got).max(), np.abs(g).max()) < 1e-6 * top, k
        else:
            np.testing.assert_allclose(
                got, g, rtol=RTOL, atol=ATOL * max(1e-3, np.abs(g).max()),
                err_msg=f"grad {k}")
        # adam moves an entry by ~lr·sign(g): one whose gradient is rounding
        # noise may step either way
        noisy = (np.abs(g) < 1e-7) | k.endswith(ZERO_GRAD)
        tol = np.where(noisy, 2 * lr, 1e-5 + 1e-5 * np.abs(new[k]) + 1e-2 * lr)
        diff = np.abs(named[k].detach().numpy() - new[k])
        assert (diff <= tol).all(), (k, float(diff.max()))
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# refusals

@pytest.mark.parametrize("opts,match", [
    (["gt.layer_type", "SAN2"], "Queue 1 item 15"),
    (["gt.gamma_learnable", "True"], "Queue 1 item 15"),
    (["gt.layer_norm", "True"], "Queue 1 item 15")])
def test_san_refuses_unported_settings(opts, match):
    from graphgps_torch.models.networks import build_model

    _, tcfg = small_cfgs(*opts, cfg_path=SAN_CFG, small=SAN_SMALL)
    with pytest.raises(NotImplementedError, match=match):
        build_model(tcfg, 1)


def test_san_without_batchnorm_refuses_fused_ffn(monkeypatch, loaders):
    """Without BatchNorm, in training with dropout, JAX takes ``fused_ffn``
    (``san.py:174-193``) with the inner dropout only; the port no longer
    refuses there: its SAN layer calls ``fused_ffn`` with ``drop2=False``
    once per layer, and the predictions are finite. In evaluation the plain
    route runs."""
    from graphgps_torch.models import san
    from graphgps_torch.models.networks import build_model

    calls = []
    real = san.fused_ffn

    def counted(*a, **k):
        calls.append(k.get("drop2"))
        return real(*a, **k)

    monkeypatch.setattr(san, "fused_ffn", counted)
    *_, tl = loaders
    _, tcfg = small_cfgs("gt.batch_norm", "False", cfg_path=SAN_CFG,
                         small=SAN_SMALL)
    model = build_model(tcfg, 1)
    _, tb = next(iter(tl["train"]))
    with torch.no_grad():
        pred, _ = model.eval()(tb)
        assert torch.isfinite(pred).all() and calls == []
        pred, _ = model.train()(tb, torch.Generator().manual_seed(0))
    assert torch.isfinite(pred).all()
    assert calls == [False] * len(model.layers)


@pytest.mark.parametrize("impl", ["ring", "dense", "chunked", "flash",
                                  "fused"])
def test_gps_refuses_attn_impl(monkeypatch, impl):
    """``gt.attn_impl`` at ogbg-molhiv's shapes (d = 64, 16 node slots):
    ring raises through ``build_model``, naming the ROADMAP item that
    brings it; dense and chunked build and take their rung in every layer;
    fused (d = 64, not lane-aligned) and flash (N < 256) raise JAX's
    ValueError when a batch arrives."""
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.ops import chunked_mha, mha
    from tests.test_torch_data import MOLHIV_CFG, MOLHIV_SMALL

    _, tcfg = small_cfgs("gt.attn_impl", impl, cfg_path=MOLHIV_CFG,
                         small=MOLHIV_SMALL)
    if impl == "ring":
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP Queue 1 item 18"):
            build_model(tcfg, 1)
        return
    splits = load_dataset(tcfg)
    loader = create_loaders(tcfg, splits, "cpu")["val"]
    model = build_model(tcfg, infer_dims(tcfg, splits)).eval()
    _, batch = next(iter(loader))
    calls = {"dense": 0, "chunked": 0}

    def spy(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(mha, "mha", spy("dense", mha.mha))
    monkeypatch.setattr(chunked_mha, "chunked_mha",
                        spy("chunked", chunked_mha.chunked_mha))
    if impl in ("fused", "flash"):
        with pytest.raises(ValueError, match=f"gt.attn_impl='{impl}' needs"):
            with torch.no_grad():
                model(batch)
        return
    with torch.no_grad():
        pred, _ = model(batch)
    assert torch.isfinite(pred).all()
    assert calls == {name: (len(model.layers) if name == impl else 0)
                     for name in calls}


# ---------------------------------------------------------------------------
# the entry point

def test_san_cli_cpu_trains_and_resumes(tmp_path):
    """The recipe at 2 layers through the entry point on the CPU: three
    epochs with ``ckpt_best`` (every stats line with a finite loss and
    ``auc``; the best epoch by val ``auc`` is the one checkpoint left and
    holds the plateau scheduler's state), then a run of two epochs that a
    second run resumes (``train.auto_resume``) to four: the resumed run's
    first lr is the one saved after epoch 1, and the state it saves after
    epoch 2 is the saved state's update by epoch 2's val ``auc`` (lr, best
    and num_bad restored); then ``inference-only`` writes one line per
    split."""
    from graphgps_torch.optim import build_schedule

    opts = [*SAN_SMALL, "optim.max_epoch", "3", "train.ckpt_best", "True",
            "out_dir", str(tmp_path / "a")]
    _run_cli(SAN_CFG, opts)
    run = tmp_path / "a" / "ogbg-molhiv-SAN" / "0"
    stats = _stats(run)
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1, 2], split
        assert all(np.isfinite(r["loss"]) and "auc" in r for r in rows)
    aucs = [r["auc"] for r in stats["val"]]
    best = max(range(3), key=lambda i: (aucs[i], -i))
    (saved,) = (run / "ckpt").glob("*.pt")
    assert saved.name == f"{best}.pt"
    sched = torch.load(saved, weights_only=True)["scheduler"]
    assert sched["lr"] == 1e-4 and sched["best"] == pytest.approx(
        max(aucs[:best + 1]), abs=1e-5)

    # stop after 2 epochs, resume to 4: patience 0 makes every epoch without
    # a gain cut the lr, so the restored state shows in the lr it sets
    run_opts = [*SAN_SMALL, "optim.schedule_patience", "0",
                "optim.reduce_factor", "0.5", "train.ckpt_period", "1",
                "out_dir", str(tmp_path / "b")]
    _, tcfg = small_cfgs(*run_opts, cfg_path=SAN_CFG, small=SAN_SMALL)
    _run_cli(SAN_CFG, [*run_opts, "optim.max_epoch", "2"])
    run = tmp_path / "b" / "ogbg-molhiv-SAN" / "0"
    first = torch.load(run / "ckpt" / "1.pt", weights_only=True)["scheduler"]
    assert set(first) == {"lr", "best", "num_bad"}
    _run_cli(SAN_CFG, [*run_opts, "optim.max_epoch", "4",
                       "train.auto_resume", "True"])
    stats = _stats(run)
    assert [r["epoch"] for r in stats["train"]] == [0, 1, 2, 3]
    assert stats["train"][2]["lr"] == pytest.approx(first["lr"], rel=1e-6)
    # epoch 2's update replayed from the restored state: lr, best, num_bad
    replay = build_schedule(tcfg)
    replay.load_state_dict(first)
    replay.update(stats["val"][2]["auc"])
    second = torch.load(run / "ckpt" / "2.pt", weights_only=True)["scheduler"]
    assert (second["lr"], second["num_bad"]) == (replay.lr, replay.num_bad)
    assert second["best"] == pytest.approx(replay.best, abs=1e-5)

    out = tmp_path / "eval"
    _run_cli(SAN_CFG, [*SAN_SMALL, "train.mode", "inference-only",
                       "out_dir", str(out)])
    for split, rows in _stats(out / "ogbg-molhiv-SAN" / "0").items():
        assert len(rows) == 1 and "auc" in rows[0], split
        assert json.dumps(rows[0])   # plain numbers
