"""What the GCN+Transformer transductive node recipes
(``configs/GPS/wn-squirrel-GPS.yaml``: the ``LapPE`` encoder alone on the raw
features, 3 x 96 GCN+Transformer layers without norms, the ``node`` head,
cross-entropy over one split's nodes, ``accuracy``) bring to the port,
against the JAX package on the CPU: the transductive stand-in (one graph,
three split masks) and its LapPE; the segment ops and ``GCNLayer`` with
repeated edges; the chunked attention against JAX's ``chunked_mha`` and
against the port's own dense rung; the GCN+Transformer ``GPSLayer`` in
evaluation and in a training step on both attention rungs; the recipe cut to
2 layers on 300 nodes for one whole train step and for evaluation, the port
at one graph slot per batch and JAX at its 32-slot host batch; the split
masks in the loss and the metrics; the actor recipe (2 x 64, no attention
dropout); the refusals; and the entry point on the CPU.

Dropout: neither the TPU kernels' bits nor flax's keys can be reproduced,
so both sides take the port's masks and the same four seeds per layer
(local drop-add, attention, attention drop-add, FFN), patched from here
(``Patches``): ``fused_tail._keep`` becomes the port's counter hash, keyed
as the port keys the drop-add (site 0) and the FFN's two sites (1 and 2),
over each site's true width (the TPU wrapper pads the FFN to 128 lanes);
``keep_mask_u8`` (JAX's dense attention) and the chunked attention's
per-chunk ``jax.random.bits`` draw the port's hash over the (B·H·N, N) view
of the probabilities, the latter at the chunk's global key columns;
``jax.random.bits`` hands the three kernel seeds out in the order the JAX
layer draws them; the port's ``draw_seeds`` returns the four, and the LapPE
signs are fixed on both sides. Each patch counts its calls.

Tolerance, f32: rtol = atol = 1e-4 for layers and models (sums in another
order through a softmax and a few layers), a gradient's atol scaled by its
tensor's largest entry; segment ops and GCN 1e-5; the chunked attention
against JAX 1e-5, against the port's dense rung 1e-5."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fused_gatedgcn import _blocked_batch
from tests.test_torch_data import small_cfgs
from tests.test_torch_ffn import ffn_keep
from tests.test_torch_grad import _mix32
from tests.test_torch_layer import randomize_norms, torch_batch
from tests.test_torch_main import ROOT
from tests.test_torch_tasks import _run_cli, _stats

torch.set_num_threads(2)

RTOL = ATOL = 1e-4
DROP, ATTN_DROP = 0.2, 0.5
# local drop-add, attention, attention drop-add, FFN
SEEDS = [1111111, 222222222, 33333, 2 ** 31 - 5]
SIGNS = np.array([1, 0, 0, 1])   # LapPE, max_freqs 4: 1 keep, 0 flip
SQUIRREL_CFG = str(ROOT / "configs/GPS/wn-squirrel-GPS.yaml")
ACTOR_CFG = str(ROOT / "configs/GPS/actor-GPS.yaml")
# 300 nodes (384 node slots), 2 layers: the port's one graph slot takes the
# wide attention's plain version, JAX's 32 slots its chunked rung (32 x 4 x
# 384^2 f32 scores are over 64 MB)
SMALL = ["gt.layers", "2", "dataset.synth_num_graphs", "300"]


# ---------------------------------------------------------------------------
# patches

def _mixed_key(seed: int, site: int) -> int:
    """mix32 of the port's key of (seed, site): what a view index below
    2^32 is xored with (``kernels/common.py`` ``drop_bits``)."""
    from graphgps_torch.ops.kernels.common import _mix32 as mix, drop_key

    return mix(drop_key(seed, site))


class Patches:
    """The port's masks and seeds on both sides of a GCN+Transformer
    layer or model of width ``d``."""

    def __init__(self, monkeypatch, d):
        from graphgps_tpu.ops import chunked_mha as jchunked
        from graphgps_tpu.ops import mha as jmha
        from graphgps_tpu.ops.pallas import fused_tail
        from graphgps_torch.models import encoders, gps_layer
        from graphgps_torch.ops.kernels.common import drop_bits

        def site(offset, shape):
            # drop-add: offset 0 on (rows, d); the FFN: offsets 0 and 1 on
            # its padded (rows, dh) and (rows, d) blocks
            return 0 if offset == 0 and shape[1] == d else offset + 1

        self.tail = ffn_keep(lambda o, s: 2 * d if site(o, s) == 1 else d,
                             site)
        self.bits_calls = self.attn_calls = self.chunk_calls = 0
        self.signs = {"jax": 0, "torch": 0}
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

        def chunk_bits(ci, shape, dtype=None):
            # the chunked rung's draw for key chunk ci of (B, H, N, chunk)
            self.chunk_calls += 1
            B, H, N, C = shape
            u32 = jnp.uint32
            row = jax.lax.broadcasted_iota(u32, shape, 0) * u32(H * N) \
                + jax.lax.broadcasted_iota(u32, shape, 1) * u32(N) \
                + jax.lax.broadcasted_iota(u32, shape, 2)
            col = ci.astype(u32) * u32(C) + jax.lax.broadcasted_iota(
                u32, shape, 3)
            h = _mix32((row * u32(N) + col) ^ u32(_mixed_key(SEEDS[1], 0)))
            return (h & u32(255)).astype(jnp.uint8)

        shim = types.ModuleType("jax")
        shim.__dict__.update(jax.__dict__)
        shim.random = types.SimpleNamespace(fold_in=lambda key, i: i,
                                            bits=chunk_bits)

        def bernoulli(key, p=0.5, shape=None):
            self.signs["jax"] += 1
            return jnp.asarray(SIGNS > 0)

        def draw_signs(gen, K):
            self.signs["torch"] += 1
            return torch.from_numpy(SIGNS * 2.0 - 1.0).float()

        monkeypatch.setattr(fused_tail, "_keep", self.tail)
        monkeypatch.setattr(jmha, "keep_mask_u8", keep_mask_u8)
        monkeypatch.setattr(jchunked, "jax", shim)
        monkeypatch.setattr(jax.random, "bits", bits)
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        monkeypatch.setattr(encoders, "draw_signs", draw_signs)
        monkeypatch.setattr(gps_layer, "draw_seeds",
                            lambda gen, n: list(SEEDS[:n]))


def force_chunked(monkeypatch, chunk: int):
    """Both packages' attention dispatch on the chunked rung, in chunks of
    ``chunk`` keys."""
    from graphgps_tpu.ops.pallas import flash_mha
    from graphgps_torch.ops import chunked_mha, mha

    monkeypatch.setattr(flash_mha, "_DENSE_MAX_N", 0)
    monkeypatch.setenv("GGPS_CHUNK", str(chunk))
    monkeypatch.setattr(mha, "DENSE_MAX_N", 0)
    monkeypatch.setattr(chunked_mha, "CHUNK", chunk)


def _close(got, want, msg, scaled=False, tol=RTOL):
    want = np.asarray(want)
    atol = tol * (max(1.0, float(np.abs(want).max())) if scaled else 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# segment ops and GCN

def _multigraph(seed=3):
    """A blocked batch of 3 graphs (up to 40 nodes, 96 edge slots each)
    with random directed pairs: self-pairs and repeated pairs included."""
    batch, x, _, nmask, emask = _blocked_batch(3, 40, 96, 64, seed=seed)
    s = np.asarray(batch.senders)[emask > 0]
    r = np.asarray(batch.receivers)[emask > 0]
    pairs = set()
    repeats = 0
    for a, b in zip(s, r):
        repeats += (a, b) in pairs
        pairs.add((a, b))
    assert repeats > 0
    return batch, x


def test_segment_ops_match_jax():
    """segment_sum with and without the edge mask, gather and in_degree on
    a batch with repeated edges: each edge counts."""
    from graphgps_tpu.ops import segment as jseg
    from graphgps_torch.ops import segment

    batch, x = _multigraph()
    tb = torch_batch(batch)
    S = tb.num_node_slots
    rng = np.random.default_rng(0)
    data = rng.standard_normal((tb.senders.shape[0], 8)).astype(np.float32)
    for mask in (None, batch.edge_mask):
        want = jseg.segment_sum(jnp.asarray(data), batch.receivers, S,
                                mask=mask)
        got = segment.segment_sum(
            torch.from_numpy(data), tb.receivers, S,
            None if mask is None else tb.edge_mask)
        _close(got, want, f"segment_sum mask={mask is not None}", tol=1e-5)
    got = segment.gather(torch.from_numpy(np.array(x)), tb.senders)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jseg.gather(x, batch.senders)))
    want = jseg.in_degree(batch.receivers, S, batch.edge_mask)
    got = segment.in_degree(tb.receivers, S, tb.edge_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gcn_layer_matches_jax():
    """``GCNLayer`` forward and the gradients of x and of its weights under
    a random cotangent, repeated edges and padded edges included."""
    from graphgps_tpu.models.local_gnn import GCNLayer as JaxGCN
    from graphgps_torch.models.local_gnn import GCNLayer

    batch, x = _multigraph(seed=5)
    jl = JaxGCN(dim=64)
    var = jl.init(jax.random.PRNGKey(1), batch, x, None, False)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        return jl.apply({"params": p}, batch, x, None, False)[0]

    want, vjp = jax.vjp(f, var["params"], x)
    jgp, jgx = vjp(jnp.asarray(cot))

    layer = GCNLayer(64)
    dense = var["params"]["Dense_0"]
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(np.array(dense["kernel"])))
        layer.b.copy_(torch.from_numpy(np.array(dense["bias"])))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    out, e = layer(torch_batch(batch), tx, None)
    assert e is None
    _close(out, want, "gcn", tol=1e-5)
    gx, gw, gb = torch.autograd.grad(out, [tx, layer.w, layer.b],
                                     torch.from_numpy(cot))
    _close(gx, jgx, "dx", True, 1e-5)
    _close(gw, jgp["Dense_0"]["kernel"], "dw", True, 1e-5)
    _close(gb, jgp["Dense_0"]["bias"], "db", True, 1e-5)


# ---------------------------------------------------------------------------
# chunked attention

def _qkv(B=3, H=4, N=120, Dh=24, seed=0, empty=1):
    """q, k, v (B, H, N, Dh) and a prefix key mask; graph ``empty`` has no
    real node."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype(np.float32)
               for _ in range(3))
    counts = rng.integers(1, N + 1, size=B)
    counts[empty] = 0
    mask = np.arange(N)[None, :] < counts[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("N,chunk", [(120, 40), (256, 128)])
def test_chunked_mha_matches_jax(monkeypatch, N, chunk):
    """At rate 0: the output and the gradients of q, k and v against JAX's
    ``chunked_mha`` (a graph with no real node included: uniform weights on
    both sides)."""
    from graphgps_tpu.ops.chunked_mha import chunked_mha as jchunked
    from graphgps_torch.ops import chunked_mha as port

    monkeypatch.setattr(port, "CHUNK", chunk)
    q, k, v, mask = _qkv(N=N)
    cot = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda q, k, v: jchunked(q, k, v, jnp.asarray(mask),
                                                 chunk=chunk), q, k, v)
    wgrads = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = port.chunked_mha(*leaves, torch.from_numpy(mask))
    _close(got, want, "out", True, 1e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for name, a, b in zip("qkv", grads, wgrads):
        _close(a, b, f"d{name}", True, 1e-5)


def test_chunked_dropout_equals_dense_mha(monkeypatch):
    """With attention dropout the chunked rung (a ragged last chunk
    included) drops exactly the units the dense ``mha`` drops for the same
    seed: outputs and gradients agree to rounding, and another seed moves
    them."""
    from graphgps_torch.ops import chunked_mha as port
    from graphgps_torch.ops.chunked_mha import chunked_mha
    from graphgps_torch.ops.kernels.common import apply_dropout
    from graphgps_torch.ops.mha import mha

    monkeypatch.setattr(port, "CHUNK", 32)
    q, k, v, mask = _qkv(N=100, seed=4)
    cot = torch.from_numpy(
        np.random.default_rng(1).standard_normal(q.shape).astype(np.float32))
    m = torch.from_numpy(mask)

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves)
        return (out, *torch.autograd.grad(out, leaves, cot))

    dense = run(lambda q, k, v: mha(
        q, k, v, m, lambda p: apply_dropout(p, 77, 0, 0.5)))
    chunked = run(lambda q, k, v: chunked_mha(q, k, v, m, seed=77,
                                              rate=0.5))
    for name, a, b in zip(("out", "dq", "dk", "dv"), chunked, dense):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.detach().abs().max()),
                                   msg=name)
    other = chunked_mha(*(torch.from_numpy(a) for a in (q, k, v)), m,
                        seed=78, rate=0.5)
    assert not torch.allclose(other, chunked[0], atol=1e-3)


def test_mha_dispatch_rule(monkeypatch):
    """Dense while N ≤ DENSE_MAX_N and the f32 scores fit DENSE_MAX_BYTES,
    as JAX's ``mha``; the rung depends on the batch's graph count."""
    from graphgps_torch.ops import mha

    assert mha.takes_dense(32, 4, 40)
    assert not mha.takes_dense(1, 4, 5248)          # N > 1,024
    assert mha.takes_dense(1, 4, 384)
    assert not mha.takes_dense(32, 4, 384)          # 75 MB of scores
    monkeypatch.setattr(mha, "DENSE_MAX_N", 0)
    assert not mha.takes_dense(32, 4, 40)


# ---------------------------------------------------------------------------
# the GCN+Transformer layer

def _jax_layer(d, act="gelu", dropout=0.0, attn_dropout=0.0,
               batch_norm=False):
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer

    return JaxGPSLayer(dim_h=d, local_gnn_type="GCN",
                       global_model_type="Transformer", num_heads=4,
                       batch_norm=batch_norm, act=act, dropout=dropout,
                       attn_dropout=attn_dropout)


@pytest.mark.parametrize("rung", ["dense", "chunked"])
@pytest.mark.parametrize("d,batch_norm,train", [
    (96, False, False), (96, False, True), (64, True, True),
    (128, False, False)])
def test_gcn_layer_step_matches_jax(monkeypatch, rung, d, batch_norm, train):
    """One GCN+Transformer layer on 3 graphs of up to 120 node slots (one
    with a single real node), dense or chunked attention on both sides:
    in evaluation the output (plain FFN at d = 96, ``fused_ffn`` at
    rate 0 at d = 128); in training (dropout 0.2, attention dropout 0.5:
    both drop-adds and the FFN through the kernels) also the gradients of
    x and of every parameter under a random cotangent and, with BatchNorm,
    the updated running statistics of its three norms."""
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    patches = Patches(monkeypatch, d)
    if rung == "chunked":
        force_chunked(monkeypatch, 40)
    batch, x, *_ = _blocked_batch(3, 120, 256, d, seed=6)
    rates = (DROP, ATTN_DROP)
    jl = _jax_layer(d, "gelu", *rates, batch_norm=batch_norm)
    var = jl.init(jax.random.PRNGKey(3), batch, x, None, False)
    params, stats = randomize_norms(var["params"],
                                    var.get("batch_stats", {}), seed=4)
    cot = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)

    def f(p, x):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x,
                            None, train, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return out[0], mut.get("batch_stats", {})

    jxo, vjp, jstats = jax.vjp(f, params, x, has_aux=True)
    jgp, jgx = vjp(jnp.asarray(cot))
    if train:
        assert patches.bits_calls == 3
        assert patches.tail.calls >= 4
        assert (patches.chunk_calls if rung == "chunked"
                else patches.attn_calls) >= 1
    else:
        assert patches.bits_calls == patches.tail.calls == 0

    layer = GPSLayer(d, 4, act="gelu", dropout=DROP, attn_dropout=ATTN_DROP,
                     local="GCN", batch_norm=batch_norm).train(train)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    txo, teo = layer(torch_batch(batch), tx, None,
                     torch.Generator().manual_seed(0))
    assert teo is None
    _close(txo, jxo, "x")
    assert (txo.detach().numpy()[~np.asarray(batch.node_mask)] == 0).all()
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(txo, [tx, *layer.parameters()],
                                torch.from_numpy(cot))
    _close(grads[0], jgx, "dx", True)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[1:]):
        _close(g, want_g[name], f"d{name}", True)
    if batch_norm and train:
        want_s = gps_layer_state_dict(params, jax.device_get(jstats))
        got_s = layer.state_dict()
        running = [k for k in want_s
                   if k.endswith(("running_mean", "running_var"))]
        assert len(running) == 6
        for k in running:
            _close(got_s[k], want_s[k], k)


def test_gcn_layer_seeds_reach_their_sites(monkeypatch):
    """Each of the four seeds the layer draws in training moves its
    output."""
    from graphgps_torch.models import gps_layer

    batch, x, *_ = _blocked_batch(3, 64, 128, 96, seed=2)
    tb, xt = torch_batch(batch), torch.from_numpy(np.array(x))
    layer = gps_layer.GPSLayer(96, 4, act="gelu", dropout=DROP,
                               attn_dropout=ATTN_DROP, local="GCN",
                               batch_norm=False).train()

    def run(seeds):
        monkeypatch.setattr(gps_layer, "draw_seeds", lambda gen, n: seeds[:n])
        with torch.no_grad():
            return layer(tb, xt, None)[0]

    base = run(SEEDS)
    assert torch.equal(base, run(SEEDS))
    for i in range(4):
        seeds = list(SEEDS)
        seeds[i] += 1
        assert not torch.equal(run(seeds), base), i


def test_layer_beyond_the_wide_kernel_is_chunked(monkeypatch):
    """Graphs of more than 768 node slots take the mha dispatch: at 1,152
    slots (N > 1,024) the chunked rung, whose output equals the dense
    rung's."""
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.ops import chunked_mha, mha

    batch, x, *_ = _blocked_batch(1, 1152, 512, 64, seed=1)
    tb, xt = torch_batch(batch), torch.from_numpy(np.array(x))
    calls = []
    real = chunked_mha.chunked_mha

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(chunked_mha, "chunked_mha", counted)
    torch.manual_seed(0)
    layer = GPSLayer(64, 4, local="GCN", batch_norm=False).eval()
    with torch.no_grad():
        got = layer(tb, xt, None)[0]
        assert calls == [1]
        monkeypatch.setattr(mha, "DENSE_MAX_N", 2048)
        want = layer(tb, xt, None)[0]
    assert calls == [1]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the transductive data path

def squirrel_loaders(*extra, cfg_path=SQUIRREL_CFG, small=SMALL):
    """(jcfg, jsplits, JAX loaders (its own create_loaders: host collation
    into train.batch_size graph slots), tcfg, tsplits, port loaders)."""
    import graphgps_tpu.data.datasets  # noqa: F401 -- registries
    from graphgps_tpu.data.datasets.base import load_dataset as jload
    from graphgps_tpu.driver import create_loaders as jloaders
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    jcfg, tcfg = small_cfgs(*extra, cfg_path=cfg_path, small=small)
    jsplits, tsplits = jload(jcfg), load_dataset(tcfg)
    return (jcfg, jsplits, jloaders(jcfg, jsplits), tcfg, tsplits,
            create_loaders(tcfg, tsplits, "cpu"))


@pytest.fixture(scope="module")
def loaders():
    return squirrel_loaders()


def _jax_batch(loader):
    return next(iter(loader)).to_graph_batch()


def test_transductive_dataset_matches_jax(loaders):
    """The stand-in of the JAX loader's fallback: one graph of 300 nodes
    with repeated edges, float features (n, 16), five classes, three
    disjoint split masks covering every node, one LapPE decomposition for
    the three views, equal to JAX's."""
    jcfg, jsplits, _, tcfg, tsplits, _ = loaders
    for split in ("train", "val", "test"):
        (jg,), (tg,) = getattr(jsplits, split), getattr(tsplits, split)
        np.testing.assert_array_equal(tg.node_feat, jg.node_feat)
        np.testing.assert_array_equal(tg.edge_index, jg.edge_index)
        np.testing.assert_array_equal(tg.y, jg.y)
        np.testing.assert_array_equal(tg.extras["split_mask"],
                                      jg.extras["split_mask"])
        np.testing.assert_array_equal(tg.pe["EigVecs"], jg.pe["EigVecs"])
        np.testing.assert_array_equal(tg.extras["EigVals"],
                                      jg.extras["EigVals"])
        assert tg.pe["EigVecs"] is tsplits.train[0].pe["EigVecs"]
    masks = np.stack([s[0].extras["split_mask"]
                      for s in (tsplits.train, tsplits.val, tsplits.test)])
    assert (masks.sum(0) == 1).all() and masks.sum(1).tolist() == [180, 60, 60]
    assert tsplits.train[0].num_nodes == 300 and tsplits.train[0].y.max() == 4


def test_transductive_batch_matches_jax_graph_slot(loaders):
    """The port's split batch is the one graph in one slot (384 node
    slots); its arrays equal those of graph 0 of JAX's 32-slot host batch:
    features, labels, the split mask, LapPE."""
    _, _, jl, _, _, tl = loaders
    for split in ("train", "val"):
        jb = _jax_batch(jl[split])
        real, tb = next(iter(tl[split]))
        assert real == 1 and tb.num_graphs == 1 and tb.max_nodes == 384
        assert jb.num_graphs == 32 and jb.max_nodes == 384
        n = tb.num_node_slots
        for got, want in (
                (tb.node_feat, jb.node_feat[:n]), (tb.y, jb.y[:n]),
                (tb.node_mask, jb.node_mask[:n]),
                (tb.extras["split_mask"].reshape(-1),
                 jb.extras["split_mask"].reshape(-1)[:n]),
                (tb.pe["EigVecs"], jb.pe["EigVecs"][:n])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(tb.edge_mask.sum()) == int(np.asarray(jb.edge_mask).sum())


def test_split_mask_loss_and_accuracy_match_jax(loaders):
    """The loss mask is the node mask AND the split's mask, as JAX's
    ``_loss_mask``; cross-entropy over it and the accuracy of the split's
    nodes agree with JAX's."""
    from graphgps_tpu.metrics import compute_task_metrics as jm
    from graphgps_tpu.models.losses import compute_loss as jloss
    from graphgps_tpu.train.loop import _loss_mask
    from graphgps_torch.metrics import compute_task_metrics
    from graphgps_torch.train.loop import compute_loss, loss_mask

    jcfg, _, jl, tcfg, _, tl = loaders
    for split in ("train", "test"):
        jb = _jax_batch(jl[split])
        _, tb = next(iter(tl[split]))
        n = tb.num_node_slots
        pred = np.random.default_rng(3).standard_normal(
            (32 * n, 5)).astype(np.float32)
        jmask = np.asarray(_loss_mask(jcfg, jb, jnp.asarray(pred)))
        tmask = loss_mask(tb, torch.from_numpy(pred[:n]))
        np.testing.assert_array_equal(tmask.numpy(), jmask[:n])
        assert not jmask[n:].any()
        assert int(tmask.sum()) == {"train": 180, "test": 60}[split]
        want = jloss(jcfg, jnp.asarray(pred), jb.y, jnp.asarray(jmask))
        want = want[0] if isinstance(want, tuple) else want
        got = compute_loss(tcfg, torch.from_numpy(pred[:n]), tb.y, tmask)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
        labels = pred[:n].argmax(-1)[tmask.numpy()]
        true = tb.y.numpy()[tmask.numpy()]
        assert compute_task_metrics("classification", labels, true) == \
            jm("classification", labels, true)


def _jax_model(jcfg, dim_out, jb):
    from graphgps_tpu.models.networks import build_model as jbuild

    jmodel = jbuild(jcfg, dim_out)
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    return jmodel, randomize_norms(var["params"],
                                   var.get("batch_stats", {}), seed=9)


def test_squirrel_model_eval_matches_jax(monkeypatch, loaders):
    """The recipe at 2 layers in evaluation: the port's one-slot batch
    against JAX's 32-slot batch, logits on every real node of the val and
    test views."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.local_gnn import GCNLayer
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    jcfg, _, jl, tcfg, tsplits, tl = loaders
    dim_out = infer_dims(tcfg, tsplits)
    assert dim_out == 5 and tcfg.share.dim_in == 16
    jb = _jax_batch(jl["val"])
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    model = build_model(tcfg, dim_out).eval()
    assert isinstance(model.layers[0].local, GCNLayer)
    assert model.layers[0].norm_out is None
    load_flax(model, params, stats)
    for split in ("val", "test"):
        jb = _jax_batch(jl[split])
        _, tb = next(iter(tl[split]))
        want, _ = jmodel.apply({"params": params, "batch_stats": stats}, jb,
                               False)
        with torch.no_grad():
            got, true = model(tb)
        n = tb.num_node_slots
        m = tb.node_mask.numpy()
        assert got.shape == (n, 5)
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[:n][m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def test_squirrel_train_step_matches_jax(monkeypatch):
    """One whole train step of the recipe at 2 layers (dropout 0.2 through
    the drop-add and FFN kernels, attention dropout 0.5 on JAX's chunked
    rung and the port's wide attention, fixed LapPE signs, cross-entropy over
    the train split's nodes, adamW, clipping): loss, clipped gradients by
    the port's parameter names and updated parameters, the port at one
    graph slot and JAX at 32."""
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_train import _clip

    lr = 1e-3
    patches = Patches(monkeypatch, 96)
    jcfg, _, jl, tcfg, tsplits, tl = squirrel_loaders(
        "optim.base_lr", str(lr), "optim.scheduler", "none")
    dim_out = infer_dims(tcfg, tsplits)
    jb = _jax_batch(jl["train"])
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    (jloss, _), jg = jax.value_and_grad(raw["forward"], has_aux=True)(
        state.params, state.batch_stats, jb, rng, jnp.asarray(0))
    state, jloss2, *_ = raw["train"](state, jb, rng)
    # per layer: three kernel seeds, the chunked attention's draws; the
    # drop-add and FFN kernels took the port's masks
    assert patches.bits_calls == 12 and patches.attn_calls == 0
    assert patches.chunk_calls > 0 and patches.tail.calls > 0
    assert patches.signs["jax"] == 2

    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    named = dict(model.named_parameters())
    init = {k: v.detach().clone() for k, v in named.items()}
    loss, pred, _, mask = train_step(tcfg, model, opt, tb,
                                     torch.Generator().manual_seed(0))
    assert patches.signs["torch"] == 1
    assert int(mask.sum()) == 180
    assert float(jloss) == pytest.approx(float(jloss2), abs=1e-7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params)).items()}
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


def test_actor_recipe_builds_and_steps():
    """The actor recipe (2 x 64, attention dropout 0) on a 200-node
    stand-in: the model builds on the GCN path, two train steps move the
    parameters with finite losses, and evaluation gives finite logits."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.local_gnn import GCNLayer
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import eval_step, train_step

    *_, tcfg, tsplits, tl = squirrel_loaders(
        cfg_path=ACTOR_CFG, small=["dataset.synth_num_graphs", "200"])
    dim_out = infer_dims(tcfg, tsplits)
    torch.manual_seed(0)
    model = build_model(tcfg, dim_out).train()
    assert len(model.layers) == 2 and model.layers[0].dim_h == 64
    assert isinstance(model.layers[0].local, GCNLayer)
    assert model.layers[0].attn_dropout == 0.0
    opt = build_optimizer(tcfg, model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator().manual_seed(0)
    _, tb = next(iter(tl["train"]))
    losses = [float(train_step(tcfg, model, opt, tb, gen)[0])
              for _ in range(2)]
    assert all(np.isfinite(losses))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))
    _, vb = next(iter(tl["val"]))
    loss, pred, _, mask = eval_step(tcfg, model.eval(), vb)
    assert torch.isfinite(pred).all() and int(mask.sum()) == 40


@pytest.mark.parametrize("opts,match", [
    (["gt.layer_type", "GIN+Transformer"], "Queue 1 item 13"),
    (["gt.layer_type", "GAT+Transformer"], "Queue 1 item 13"),
    (["gt.layer_type", "GENConv+Transformer"], "Queue 1 item 13"),
    (["gt.layer_type", "PNA+Transformer"], "Queue 1 item 13"),
    (["gt.layer_type", "GINE+BiasedTransformer"], "Queue 1 item 15"),
    (["gt.layer_norm", "True"], "Queue 1 item 15")])
def test_gcn_recipe_refusals(opts, match):
    """What the GCN+Transformer recipes still refuse, each naming its
    ROADMAP item; BatchNorm on GCN is taken."""
    from graphgps_torch.models.networks import build_model

    _, tcfg = small_cfgs(*opts, cfg_path=SQUIRREL_CFG, small=SMALL)
    tcfg.share.dim_in = 16
    with pytest.raises(NotImplementedError, match=match):
        build_model(tcfg, 5)
    _, tcfg = small_cfgs("gt.batch_norm", "True", cfg_path=SQUIRREL_CFG,
                         small=SMALL)
    tcfg.share.dim_in = 16
    assert build_model(tcfg, 5).layers[0].norm_out is not None


def test_squirrel_cli_cpu_trains(tmp_path):
    """Three epochs of the recipe at 2 layers through the entry point on the
    CPU: one train line per epoch, val and test lines at the evaluated
    epochs (``eval_period`` 5: the first and the last), each with a finite
    loss and ``accuracy``; then ``inference-only`` writes one line per
    split."""
    opts = [*SMALL, "optim.max_epoch", "3", "optim.num_warmup_epochs", "1",
            "out_dir", str(tmp_path)]
    _run_cli(SQUIRREL_CFG, opts)
    stats = _stats(tmp_path / "wn-squirrel-GPS" / "0")
    assert [r["epoch"] for r in stats["train"]] == [0, 1, 2]
    for split in ("val", "test"):
        assert [r["epoch"] for r in stats[split]] == [0, 2]
    for rows in stats.values():
        for r in rows:
            assert np.isfinite(r["loss"]) and 0.0 <= r["accuracy"] <= 1.0
    _run_cli(SQUIRREL_CFG, [*SMALL, "train.mode", "inference-only",
                            "out_dir", str(tmp_path / "eval")])
    stats = _stats(tmp_path / "eval" / "wn-squirrel-GPS" / "0")
    assert {k: len(v) for k, v in stats.items()} == {
        "train": 1, "val": 1, "test": 1}
