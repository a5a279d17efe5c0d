"""What the ZINC Graphormer recipe (``configs/Graphormer/zinc-Graphormer.yaml``:
``TypeDictNode+GraphormerBias``, 12 x 80 Graphormer layers with 8 heads and
the graph token, ``graphormer_graph`` head, L1, adamW under
``polynomial_with_warmup``) brings to the port, against the JAX package on
the CPU: the shortest-path statistics integer for integer, the loader's
batch against JAX's host ``collate``, the encoders, flax's LayerNorm, one
Graphormer layer through the ``fused_ln_ffn`` kernel's path (d = 64) and
through the plain path (d = 16) in evaluation and in a training step, and
the reference-extracted ``graphormer_layer`` fixture. The whole model, the
schedule and the entry point: ``test_torch_graphormer_model.py``.

Dropout. The port's masks go to both packages, patched from here with
nothing changed in either: JAX's ``fused_combine._keep`` (the kernel's sites
1 and 2 over their true widths), ``graphgps_tpu.ops.mha.keep_mask_u8`` (the
attention probabilities, the (B·H·S, S) view), ``jax.random.bits`` (the
kernel's seed) and ``jax.random.bernoulli`` (flax ``nn.Dropout``: the input
dropout, the attention output's and the plain MLP's, the port's exact-rate
rule ``exact_dropout``), and the port's ``draw_seeds``. Each patch counts
its calls, so a JAX path that took another route fails the test.

Tolerances, f32: integers exact; encoders and LayerNorm rtol 1e-5 with the
atol 1e-5 × the tensor's largest entry; a layer and the model rtol = atol =
1e-4 (a gradient's atol scaled by its tensor's largest entry), the fixture
rtol 1e-4 and atol 1e-5 as ``tests/test_reference_fixtures.py`` holds JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import both_loaders
from tests.test_torch_layer import randomize_norms
from tests.test_torch_main import ROOT
from tests.test_torch_unmerged import keep_at

torch.set_num_threads(2)

ZINC_CFG = str(ROOT / "configs/Graphormer/zinc-Graphormer.yaml")
# the recipe at 2 x 64, 4 heads; 40 graphs in batches of 8: train 32
# (4 batches), val and test 4 (one half-filled batch each); 40 node slots
ZINC_SMALL = ["graphormer.num_layers", "2", "graphormer.embed_dim", "64",
              "graphormer.num_heads", "4", "gnn.dim_inner", "64",
              "train.batch_size", "8", "dataset.synth_num_graphs", "40"]
RTOL = ATOL = 1e-4
# per layer: attention, attention output, MLP block; the input dropout's
LAYER_SEEDS = [1234567, 7654321, 2 ** 31 - 9]
INPUT_SEED = 31337


class Drops:
    """The port's masks in both packages (see the module docstring).
    ``bernoulli`` is answered in the order flax draws: ``order`` holds the
    (seed, site) of each call; ``kernel_width`` is the kernel sites' true
    width."""

    def __init__(self, monkeypatch, order, kernel_width=None):
        from graphgps_tpu.ops import mha as jmha
        from graphgps_tpu.ops.pallas import fused_combine
        from graphgps_torch.models import graphormer
        from graphgps_torch.ops.kernels.common import drop_bits

        self.order = list(order)
        self.bernoulli = self.bits = self.attn = 0
        self.keep = keep_at({1: kernel_width, 2: kernel_width})
        real_bits = jax.random.bits

        def bits(key, shape=(), dtype=None):
            if tuple(shape) != ():
                return real_bits(key, shape, dtype)
            self.bits += 1
            return jnp.asarray(LAYER_SEEDS[2], jnp.uint32)

        def keep_mask_u8(rng, rate, shape):
            self.attn += 1
            t = min(max(int(round(rate * 256)), 1), 255)
            b = drop_bits(LAYER_SEEDS[0], 0, int(np.prod(shape[:-1])),
                          shape[-1]).numpy()
            return jnp.asarray(((b & 255) >= t).reshape(shape)), 1.0 - t / 256.0

        def bernoulli(key, p=0.5, shape=None):
            seed, site = self.order[self.bernoulli % len(self.order)]
            self.bernoulli += 1
            b = drop_bits(seed, site, int(np.prod(shape[:-1])), shape[-1])
            u = (b >> 8).to(torch.float32) * 2.0 ** -24
            return jnp.asarray((u < p).numpy().reshape(shape))

        def draw_seeds(gen, n):
            return [INPUT_SEED] if n == 1 else list(LAYER_SEEDS[:n])

        monkeypatch.setattr(fused_combine, "_keep", self.keep)
        monkeypatch.setattr(jmha, "keep_mask_u8", keep_mask_u8)
        monkeypatch.setattr(jax.random, "bits", bits)
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        monkeypatch.setattr(graphormer, "draw_seeds", draw_seeds)


def _close(got, want, msg, rtol=RTOL, atol=ATOL, scaled=True):
    want = np.asarray(want)
    if scaled:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def loaders():
    return both_loaders(cfg_path=ZINC_CFG, small=ZINC_SMALL)


def _batches(loaders, split):
    """(JAX GraphBatch, port GraphBatch) of a split's first batch."""
    _, _, jl, _, _, tl = loaders
    return (next(iter(jl[split])).to_graph_batch(),
            next(iter(tl[split]))[1])


# ---------------------------------------------------------------------------
# data

def test_graphormer_bias_matches_jax(loaders):
    """``graphormer_bias`` on every graph of the stand-in (through
    ``compute_posenc``: spatial types, degrees and the edge types along the
    BFS shortest paths) and on random multigraphs with self loops and
    several components, undirected and directed: the same integers."""
    from graphgps_tpu.data.graph import Graph as JGraph
    from graphgps_tpu.pe.host import graphormer_bias as jbias
    from graphgps_torch.data.graph import Graph
    from graphgps_torch.pe.host import graphormer_bias

    _, jsplits, _, tcfg, tsplits, _ = loaders
    assert tcfg.dataset.format == "PyG-ZINC"
    for a, b in zip(jsplits.all_graphs, tsplits.all_graphs):
        for k in ("spatial_types", "shortest_path_types"):
            np.testing.assert_array_equal(a.extras[k], b.extras[k], k)
        for k in ("in_degrees", "out_degrees"):
            np.testing.assert_array_equal(a.pe[k], b.pe[k], k)
    assert b.extras["shortest_path_types"].dtype == np.uint8
    rng = np.random.default_rng(3)
    for _ in range(20):
        n, m = int(rng.integers(1, 24)), int(rng.integers(1, 40))
        ei = rng.integers(0, n, size=(2, m))
        ef = rng.integers(0, 4, size=(m, 1))
        x = np.zeros((n, 1), np.int64)
        for directed in (False, True):
            want = jbias(JGraph(node_feat=x, edge_index=ei, edge_feat=ef), 6,
                         directed, True)
            got = graphormer_bias(Graph(node_feat=x, edge_index=ei,
                                        edge_feat=ef), 6, directed, True)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_graphormer_loader_matches_jax_collate(loaders, split):
    """Batch for batch against the JAX driver's loader for this recipe (host
    ``collate``, a shuffled train epoch and a half-filled val batch): node
    types, masks, targets, the degrees among ``pe``, and ``spatial_types``
    and ``shortest_path_types`` among ``extras``, zero-padded to the node
    cap and zero for a padded graph."""
    _, _, jl, _, _, tl = loaders
    n = 0
    for hb, (treal, tb) in zip(jl[split], tl[split]):
        n += 1
        jb = hb.to_graph_batch()
        assert (tb.num_graphs, tb.max_nodes) == (jb.num_graphs,
                                                 jb.max_nodes) == (8, 40)
        for name in ("node_feat", "node_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name)
        assert treal == int(np.asarray(jb.graph_mask).sum())
        assert tb.pe["in_degrees"].dtype == torch.int32
        for k in ("in_degrees", "out_degrees"):
            np.testing.assert_array_equal(tb.pe[k].numpy(),
                                          np.asarray(jb.pe[k]), k)
        assert tb.extras["shortest_path_types"].dtype == torch.uint8
        assert tb.extras["shortest_path_types"].shape == (8, 40, 40, 20)
        for k in ("spatial_types", "shortest_path_types"):
            np.testing.assert_array_equal(tb.extras[k].numpy(),
                                          np.asarray(jb.extras[k]), k)
    assert n == len(tl[split]) > 0
    if split == "val":   # the last batch against ``collate`` itself
        from graphgps_tpu.data.batching import collate

        _, jsplits, _, _, _, _ = loaders
        hb = collate(jsplits.val, 8, 40, 8 * 64)
        for k in ("spatial_types", "shortest_path_types"):
            np.testing.assert_array_equal(tb.extras[k].numpy(),
                                          hb.extras[k], k)
        np.testing.assert_array_equal(tb.pe["in_degrees"].numpy(),
                                      hb.pe["in_degrees"])


# ---------------------------------------------------------------------------
# modules

def _boost(tree, factor=50.0):
    """The GraphormerBias encoder's leaves scaled up from their N(0, 0.02)
    init, so the bias and the degree terms weigh in the checks."""
    def walk(t, inside):
        if isinstance(t, dict):
            return {k: walk(v, inside or k == "GraphormerBiasEncoder_0")
                    for k, v in t.items()}
        t = np.asarray(t)
        return (t * factor).astype(np.float32) if inside else t
    return walk(jax.device_get(tree), False)


def test_encoders_match_jax(loaders):
    """The whole FeatureEncoder (``TypeDictNode+GraphormerBias``, edge paths
    on, the graph token) on a half-filled batch: x on the real nodes, the
    attention bias with the token's row and column, the token states."""
    from graphgps_tpu.config.config import FrozenCfg
    from graphgps_tpu.models.networks import FeatureEncoder as JaxEncoder
    from graphgps_torch.models.encoders import FeatureEncoder
    from graphgps_torch.weights import _encoder_state_dict, to_torch

    jcfg, _, _, tcfg, _, _ = loaders
    jb, tb = _batches(loaders, "val")
    jenc = JaxEncoder(cfg=FrozenCfg(jcfg), dim_h=64)
    params = _boost(jenc.init(jax.random.PRNGKey(0), jb, False)["params"])
    jb = jb.replace(extras=dict(jb.extras))
    jx, _ = jenc.apply({"params": params}, jb, False)

    enc = FeatureEncoder(tcfg, 64)
    sd = {}
    _encoder_state_dict(sd, params, None)
    missing, unexpected = enc.load_state_dict(
        {k[len("encoder."):]: v for k, v in to_torch(sd).items()},
        strict=False)
    assert not missing and not unexpected
    with torch.no_grad():
        x, e = enc(tb)
        bias = enc.graphormer.attn_bias(tb)
        tok = enc.graphormer.token_state(tb.num_graphs)
    assert e is None and bias.shape == (8, 4, 41, 41)
    m = tb.node_mask.numpy()
    _close(x[tb.node_mask], np.asarray(jx)[m], "x", RTOL * 0.1, ATOL * 0.1)
    assert not x[~tb.node_mask].any()
    _close(bias, jb.extras["attn_bias"], "attn_bias", RTOL * 0.1, ATOL * 0.1)
    _close(tok, jb.extras["graph_token_state"], "token", RTOL * 0.1,
           ATOL * 0.1)


def test_layernorm_matches_flax():
    """flax's LayerNorm (eps 1e-6, the fast variance) on rows with an offset
    of a few times their spread, and on rows of spread 1e-2, where torch's
    eps of 1e-5 would part from it by several percent."""
    from flax import linen as nn
    from graphgps_torch.models.common import LayerNorm

    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal((32, 80)) + 3.0 * rng.standard_normal((32, 1)),
        1e-2 * rng.standard_normal((32, 80))]).astype(np.float32)
    p = {"scale": np.asarray(1 + 0.1 * rng.standard_normal(80), np.float32),
         "bias": np.asarray(0.1 * rng.standard_normal(80), np.float32)}
    want = nn.LayerNorm().apply({"params": p}, jnp.asarray(x))
    mine = LayerNorm(80)
    mine.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                          "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = mine(torch.from_numpy(x))
    _close(got, want, "layernorm", 1e-5, 1e-5)


def _layer_inputs(jb, d, H, seed):
    rng = np.random.default_rng(seed)
    S = jb.max_nodes + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(jb.num_graphs * jb.max_nodes, d), f(jb.num_graphs, d),
            f(jb.num_graphs, H, S, S))


@pytest.mark.parametrize("d,train", [(64, False), (64, True), (16, False),
                                     (16, True)])
def test_graphormer_layer_matches_jax(monkeypatch, loaders, d, train):
    """One layer, 4 heads, with the graph token and a random bias on a
    half-filled batch (8 graphs × 41 rows: the kernel's envelope at d = 64,
    the plain path at d = 16), dropout 0.2 on the attention output and the
    MLP's output, 0.3 on the attention probabilities, 0.1 inside the MLP: x
    and the token state out; in training also the gradients of x, the token
    state, the bias and every parameter under random cotangents."""
    from graphgps_tpu.models.graphormer import GraphormerLayer as JLayer
    from graphgps_torch.models.graphormer import GraphormerLayer
    from graphgps_torch.weights import graphormer_layer_state_dict, to_torch

    H = 4
    rates = dict(dropout=0.2, attn_dropout=0.3, mlp_dropout=0.1)
    plain = d < 64
    s1, s2 = LAYER_SEEDS[1], LAYER_SEEDS[2]
    order = [(s1, 0)] + ([(s2, 1), (s2, 2)] if plain else [])
    drops = Drops(monkeypatch, order, kernel_width=d)
    jb, tb = _batches(loaders, "val")
    x, tok, bias = _layer_inputs(jb, d, H, seed=d)
    rng = np.random.default_rng(d + 1)
    cx = rng.standard_normal(x.shape).astype(np.float32)
    ct = rng.standard_normal(tok.shape).astype(np.float32)
    jl = JLayer(dim_h=d, num_heads=H, **rates)

    def jrun(params, x, tok, bias):
        b = jb.replace(extras={"attn_bias": bias, "graph_token_state": tok})
        xo, _ = jl.apply({"params": params}, b, x, None, train,
                         rngs={"dropout": jax.random.PRNGKey(1)})
        return xo, b.extras["graph_token_state"]

    init = jl.init({"params": jax.random.PRNGKey(2)},
                   jb.replace(extras={"attn_bias": jnp.asarray(bias),
                                      "graph_token_state": jnp.asarray(tok)}),
                   jnp.asarray(x), None, False)
    params = randomize_norms(init["params"], {}, seed=d)[0]
    jargs = (params, jnp.asarray(x), jnp.asarray(tok), jnp.asarray(bias))
    want_x, want_t = jrun(*jargs)

    layer = GraphormerLayer(d, H, **rates).train(train)
    layer.load_state_dict(to_torch(graphormer_layer_state_dict(params)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, tok, bias)]
    got_x, got_t = layer(tb, ins[0], ins[1], ins[2], torch.Generator())
    _close(got_x, want_x, "x")
    _close(got_t, want_t, "token")
    if train:
        # per forward: the output dropout, the plain MLP's two; the kernel
        # seed and both of its sites; the probabilities
        assert drops.bernoulli == len(order)
        assert (drops.bits, drops.keep.calls) == ((0, 0) if plain else (1, 2))
        assert drops.attn == 1
    if not train:
        assert drops.bernoulli == drops.bits == drops.attn == 0
        return

    def jloss(params, x, tok, bias):
        xo, to = jrun(params, x, tok, bias)
        return jnp.sum(xo * cx) + jnp.sum(to * ct)

    wgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    loss = (got_x * torch.from_numpy(cx)).sum() + (
        got_t * torch.from_numpy(ct)).sum()
    names = [k for k, _ in layer.named_parameters()]
    grads = torch.autograd.grad(loss, [*ins, *layer.parameters()])
    for name, g, w in zip(("x", "tok", "bias"), grads[:3], wgrads[1:]):
        _close(g, w, f"grad {name}")
    want_p = graphormer_layer_state_dict(jax.device_get(wgrads[0]))
    assert set(want_p) == set(names)
    for name, g in zip(names, grads[3:]):
        _close(g, want_p[name], f"grad {name}")


def test_graphormer_layer_matches_reference_fixture():
    """The ``graphormer_layer`` case of the reference-extracted fixtures
    (``tests/test_reference_fixtures.py:260``): two graphs, d = 16, 2 heads,
    a (B·H, N, N) bias, no token, evaluation; the plain MLP path."""
    from graphgps_torch.data.graph import GraphBatch
    from graphgps_torch.models.graphormer import GraphormerLayer
    from tests.test_reference_fixtures import FIX, _two_graph_batch

    z = np.load(FIX, allow_pickle=True)
    case = z["graphormer_layer"].item()
    st = case["state"]
    d, H = 16, 2
    gb, x, slot_of = _two_graph_batch(case)
    n = gb.max_nodes
    tb = GraphBatch(node_feat=torch.from_numpy(np.array(x)), edge_feat=None,
                    senders=torch.zeros(1, dtype=torch.int32),
                    receivers=torch.zeros(1, dtype=torch.int32),
                    node_mask=torch.from_numpy(np.array(gb.node_mask)),
                    edge_mask=torch.zeros(1, dtype=torch.bool),
                    graph_mask=torch.ones(2, dtype=torch.bool), y=None, pe={},
                    num_graphs=2, max_nodes=n, edge_block=1)
    w_in = np.asarray(st["attention.in_proj_weight"])    # (3d, d) [q; k; v]
    b_in = np.asarray(st["attention.in_proj_bias"])
    sd = {"ln_attn.weight": st["input_norm.weight"],
          "ln_attn.bias": st["input_norm.bias"],
          "w_qkv": w_in.T, "b_qkv": b_in,
          "w_out": np.asarray(st["attention.out_proj.weight"]).T,
          "b_out": st["attention.out_proj.bias"],
          "ln_ffn.weight": st["mlp.0.weight"], "ln_ffn.bias": st["mlp.0.bias"],
          "w_ffn1": np.asarray(st["mlp.1.weight"]).T, "b_ffn1": st["mlp.1.bias"],
          "w_ffn2": np.asarray(st["mlp.4.weight"]).T,
          "b_ffn2": st["mlp.4.bias"]}
    layer = GraphormerLayer(d, H).eval()
    layer.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()})
    bias = torch.from_numpy(case["attn_bias"].reshape(2, H, n, n))
    with torch.no_grad():
        out, tok = layer(tb, tb.node_feat, None, bias)
    assert tok is None
    np.testing.assert_allclose(out.numpy()[slot_of], case["out_x"],
                               rtol=1e-4, atol=1e-5)
