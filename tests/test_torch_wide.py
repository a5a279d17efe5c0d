"""The port's two long-graph kernel functions and the GPS layer that runs
them, against the JAX package on the CPU.

``fused_edge_gate`` and ``fused_wide_attention`` run as Pallas kernels in
interpret mode, called the way the JAX layers call them: the edge axis padded
to whole groups of 8 tiles of 128 edges, the width zero-padded to 128 lanes,
and for d = 96 the heads padded through ``pad_heads`` with the true
``1/sqrt(Dh)`` as the scale. The port's functions run their plain versions
(CPU tensors). Forward and every gradient under random cotangents. JAX is
imported inside the tests that use it, so the card-only test at the end of
the kernels' part runs on a machine without it.

Dropout on the attention probabilities: the TPU kernel's bits cannot be
reproduced, so ``fused_attn_wide._keep_bits`` is patched from here to the
port's counter hash over the (B·H·N, N) view (the kernel hands it
``seed + b·131071 + c`` for key chunk ``c`` of graph ``b``; the patch takes
``b`` from the grid and ``c`` from the difference). In the layer test the JAX
layer computes the same function through its dense attention on the CPU, and
``graphgps_tpu.ops.mha.keep_mask_u8`` is patched as in
``test_torch_unmerged.py``. Each patch counts its calls.

Tolerance, f32: kernel functions rtol = 1e-5, atol = 1e-5 × the tensor's
largest entry (sums in another order; a gradient entry is a sum of many terms
that cancel). The layer: rtol = atol = 1e-4, a gradient's atol scaled by its
tensor's largest entry, as in ``test_torch_unmerged.py``."""
import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
SEED = 24680
ATTN_SEED = 222222222


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=msg)


# ---------------------------------------------------------------------------
# fused_edge_gate

def _edge_gate_inputs(B, N, E, d, seed, stray=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    s = rng.integers(0, N, (B, E)).astype(np.int32)
    r = np.sort(rng.integers(0, N, (B, E)), axis=1).astype(np.int32)
    if stray:   # endpoints outside the graph gather zeros, scatter nowhere
        s[:, ::7] = N + 3
        r[:, ::5] = -1
    em = (rng.random((B, E)) < 0.85).astype(np.float32)
    return f(B, N, d), f(B, N, 2 * d), f(B, E, d), s, r, em


def _jax_edge_gate(pd, peb, ce, s, r, em):
    """``fused_edge_gate`` as ``GatedGCNLayer`` calls it
    (``local_gnn.py:199-232``): 128 lanes, whole groups of 8 x 128 edges."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_edge_gate import ET, TG, fused_edge_gate

    B, N, d = pd.shape
    E = ce.shape[1]
    dp = -(-d // 128) * 128
    Ep = -(-E // (TG * ET)) * (TG * ET)
    padf = lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, dp - d)))  # noqa: E731
    padE = lambda t: jnp.pad(  # noqa: E731
        t, ((0, 0), (0, Ep - E)) + ((0, 0),) * (t.ndim - 2))
    gate4, nd3 = fused_edge_gate(
        padf(pd), jnp.concatenate([padf(peb[..., :d]), padf(peb[..., d:])], -1),
        padE(padf(ce)).reshape(B, -1, ET, dp), padE(s).reshape(B, -1, ET),
        padE(r).reshape(B, -1, ET), padE(em).reshape(B, -1, ET))
    gate = gate4.reshape(B, Ep, dp)[:, :E, :d]
    return gate, jnp.concatenate([nd3[..., :d], nd3[..., dp:dp + d]], -1)


@pytest.mark.parametrize("B,N,E,d,stray", [(3, 40, 100, 96, False),
                                           (2, 136, 300, 128, False),
                                           (2, 64, 200, 96, True)])
def test_edge_gate_matches_jax(B, N, E, d, stray):
    """gate, nd and the gradients of pd, peb and ce; the backward wrapper
    gives the same gradients as autograd through the function."""
    import jax
    import jax.numpy as jnp
    from graphgps_torch.ops.kernels.edge_gate import (edge_gate_backward,
                                                      fused_edge_gate)

    pd, peb, ce, s, r, em = _edge_gate_inputs(B, N, E, d, 3, stray)
    rng = np.random.default_rng(5)
    cots = [rng.standard_normal(a).astype(np.float32)
            for a in ((B, E, d), (B, N, 2 * d))]
    want, vjp = jax.vjp(lambda a, b, c: _jax_edge_gate(a, b, c, s, r, em),
                        pd, peb, ce)
    want_g = vjp(tuple(jnp.asarray(c) for c in cots))

    ins = [torch.from_numpy(a).requires_grad_() for a in (pd, peb, ce)]
    idx = [torch.from_numpy(a) for a in (s, r, em)]
    got = fused_edge_gate(*ins, *idx)
    tc = [torch.from_numpy(c) for c in cots]
    got_g = torch.autograd.grad(got, ins, tc)
    for name, a, b in zip(("gate", "nd"), got, want):
        _close(a, b, name)
    for name, a, b in zip(("dpd", "dpeb", "dce"), got_g, want_g):
        _close(a, b, name)
    # the wrapper runs autograd through the same plain version (index_add on
    # several CPU threads may add in another order, so not bit for bit)
    again = edge_gate_backward(*(t.detach() for t in ins), *idx, *tc)
    for a, b in zip(again, got_g):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_edge_gate_refuses_other_devices():
    from graphgps_torch.ops.kernels.edge_gate import (edge_gate_backward,
                                                      fused_edge_gate)

    args = [torch.from_numpy(a).to("meta")
            for a in _edge_gate_inputs(1, 8, 8, 8, 0)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_edge_gate(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        edge_gate_backward(*args, args[2], args[1])


# ---------------------------------------------------------------------------
# fused_wide_attention

def _attn_inputs(B, N, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    counts = rng.integers(1, N + 1, (B,)).astype(np.int32)
    counts[0], counts[-1] = 0, N     # a graph with no real node, a full one
    return (f(B, N, d), counts, f(d, 3, d) / np.sqrt(d).astype(np.float32),
            0.1 * f(3, d), f(d, d) / np.sqrt(d).astype(np.float32), 0.1 * f(d))


def _jax_wide(x, counts, wqkv3, bqkv2, wo, bo, H, rate):
    """``fused_wide_attention`` as ``GPSLayer`` calls it
    (``gps_layer.py:330-346``)."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_attn_wide import fused_wide_attention
    from graphgps_tpu.ops.pallas.fused_gps_attn import pad_heads

    d = x.shape[-1]
    wq, bq, wo_p, bo_p, dp = pad_heads(wqkv3, bqkv2, wo, bo, H)
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, dp - d))) if dp != d else x
    return fused_wide_attention(xp, jnp.asarray(counts), wq, bq, wo_p, bo_p,
                                jnp.asarray(SEED, jnp.int32), H,
                                1.0 / float(d // H) ** 0.5, rate)[..., :d]


def _port_keep_bits(N, H):
    """The port's mask with the signature of ``_keep_bits``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from tests.test_torch_grad import _mix32

    def keep_bits(seed, shape, rate):
        keep_bits.calls += 1
        t = min(max(int(round(rate * 256)), 1), 255)
        u32 = jnp.uint32
        b = pl.program_id(0)
        chunk = (seed - SEED - b * 131071).astype(u32)
        key = _mix32(u32(SEED) + u32(0x9E3779B9))
        row = (b.astype(u32) * u32(H * N)
               + jax.lax.broadcasted_iota(u32, shape, 0))
        idx = (row * u32(N) + chunk * u32(shape[1])
               + jax.lax.broadcasted_iota(u32, shape, 1))
        bits = _mix32(idx ^ _mix32(key))
        return ((bits & u32(255)) >= u32(t)).astype(jnp.float32), \
            1.0 / (1.0 - t / 256.0)

    keep_bits.calls = 0
    return keep_bits


@pytest.mark.parametrize("B,N,d,H,rate", [(3, 256, 96, 4, 0.0),
                                          (3, 256, 96, 4, 0.5),
                                          (2, 128, 96, 8, 0.5),
                                          (2, 256, 128, 4, 0.5)])
def test_wide_attention_matches_jax(monkeypatch, B, N, d, H, rate):
    """y and the gradients of x and the four weights, with a graph of
    ``counts`` 0 and one of ``counts`` N, dropout off and on (the port's
    masks on both sides); the backward wrapper agrees with autograd."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import fused_attn_wide
    from graphgps_torch.ops.kernels.wide_attention import (
        fused_wide_attention, wide_attention_backward)

    keep = _port_keep_bits(N, H)
    monkeypatch.setattr(fused_attn_wide, "_keep_bits", keep)
    x, counts, wqkv3, bqkv2, wo, bo = _attn_inputs(B, N, d, 7)
    gy = np.random.default_rng(9).standard_normal((B, N, d)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda *a: _jax_wide(a[0], counts, *a[1:], H, rate),
        x, wqkv3, bqkv2, wo, bo)
    want_g = vjp(jnp.asarray(gy))
    assert (keep.calls > 0) == (rate > 0)

    ins = [torch.from_numpy(a).requires_grad_() for a in
           (x, wqkv3.reshape(d, 3 * d), bqkv2.reshape(3 * d), wo, bo)]
    tcounts = torch.from_numpy(counts)
    conf = (SEED, H, 1.0 / float(d // H) ** 0.5, rate)
    got = fused_wide_attention(ins[0], tcounts, *ins[1:], *conf)
    got_g = torch.autograd.grad(got, ins, torch.from_numpy(gy))
    _close(got, want, "y")
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got_g,
                          want_g):
        _close(a, np.asarray(b).reshape(a.shape), name)
    # the graph with no real node attends uniformly and passes gradient
    assert float(got_g[0][0].abs().max()) > 0
    again = wide_attention_backward(ins[0].detach(), tcounts,
                                    *(t.detach() for t in ins[1:]), *conf,
                                    torch.from_numpy(gy))
    for a, b in zip(again, got_g):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wide_attention_plain_is_the_layers_branch():
    """With every graph holding a real node, the function equals the
    PyTorch-ops branch the layer takes up to 128 node slots (same masks from
    the same seed), forward and gradient."""
    from graphgps_torch.data.graph import GraphBatch
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.ops.kernels.wide_attention import fused_wide_attention

    B, N, d, H = 3, 24, 96, 4
    x, counts, *_ = _attn_inputs(B, N, d, 1)
    counts[0] = 5
    torch.manual_seed(0)
    layer = GPSLayer(d, H, attn_dropout=0.5).train()
    nm = torch.arange(N)[None, :] < torch.from_numpy(counts)[:, None]
    z = torch.zeros(0)
    batch = GraphBatch(node_feat=z, edge_feat=None, senders=z, receivers=z,
                       node_mask=nm.reshape(-1), edge_mask=z, graph_mask=z,
                       y=None, pe={}, num_graphs=B, max_nodes=N, edge_block=0)
    assert torch.equal(batch.counts, torch.from_numpy(counts))
    xs = [torch.from_numpy(x).reshape(B * N, d).requires_grad_()
          for _ in range(2)]
    want = layer.attention(batch, xs[0], SEED)
    got = fused_wide_attention(xs[1].reshape(B, N, d), batch.counts,
                               layer.w_qkv, layer.b_qkv, layer.w_out,
                               layer.b_out, SEED, H, 1 / (d // H) ** 0.5, 0.5)
    torch.testing.assert_close(got.reshape(B * N, d), want, rtol=1e-6,
                               atol=1e-6)
    gw, gg = (torch.autograd.grad(o.sum(), i)[0]
              for o, i in ((want, xs[0]), (got, xs[1])))
    torch.testing.assert_close(gg, gw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_wide_attention_plain_in_float64_is_float64_throughout(rate):
    """A float64 run of the plain version is the reference of an
    ill-conditioned training step, so no part of it may round to f32: it
    agrees with the same function written out in f64 to 1e-12 (an f32
    softmax inside leaves 1e-8), and with its own f32 run to f32 rounding."""
    from graphgps_torch.ops.kernels.common import apply_dropout
    from graphgps_torch.ops.kernels.wide_attention import wide_attention_plain
    from graphgps_torch.ops.mha import merge_heads, split_heads

    B, N, d, H = 2, 40, 96, 4
    x, counts, wqkv3, bqkv2, wo, bo = _attn_inputs(B, N, d, 2)
    args = [torch.from_numpy(a) for a in
            (x, counts, wqkv3.reshape(d, 3 * d), bqkv2.reshape(3 * d), wo, bo)]
    scale = 1 / (d // H) ** 0.5
    conf = (SEED, H, scale, rate)
    y32 = wide_attention_plain(*args, *conf)
    x64, cnt, wqkv, bqkv, wo64, bo64 = (
        a.double() if a.is_floating_point() else a for a in args)
    y64 = wide_attention_plain(x64, cnt, wqkv, bqkv, wo64, bo64, *conf)
    assert y64.dtype == torch.float64
    top = float(y64.abs().max())
    torch.testing.assert_close(y32.double(), y64, rtol=1e-5, atol=1e-5 * top)

    qkv = x64 @ wqkv + bqkv
    q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H) for i in range(3))
    logits = torch.einsum("bhnd,bhmd->bhnm", q * scale, k)
    keys = torch.arange(N)[None, :] < cnt[:, None]
    p = torch.softmax(logits.masked_fill(~keys[:, None, None, :], -1e30),
                      dim=-1)
    assert p.dtype == torch.float64
    if rate > 0:
        p = apply_dropout(p, SEED, 0, rate)
    want = merge_heads(torch.einsum("bhnm,bhmd->bhnd", p, v)) @ wo64 + bo64
    torch.testing.assert_close(y64, want, rtol=1e-12, atol=1e-12 * top)


def test_wide_attention_refuses():
    from graphgps_torch.ops.kernels.wide_attention import fused_wide_attention

    x, counts, wqkv3, bqkv2, wo, bo = _attn_inputs(1, 8, 8, 0)
    args = [torch.from_numpy(a) for a in
            (x, counts, wqkv3.reshape(8, 24), bqkv2.reshape(24), wo, bo)]
    with pytest.raises(ValueError, match="dropout"):
        fused_wide_attention(*args, 0, 2, 0.5, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_wide_attention(*(a.to("meta") for a in args), 0, 2, 0.5, 0.0)


@pytest.fixture
def cuda_device():
    """Decided inside the fixture, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _grads(fn, ins):
    """(outputs, gradients of ``ins``) of ``fn`` under seeded cotangents."""
    leaves = [t.clone().requires_grad_() for t in ins]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    cots = [torch.randn(o.shape, generator=torch.Generator()
                        .manual_seed(3 + j)).to(o.device)
            for j, o in enumerate(out)]
    return out, torch.autograd.grad(out, leaves, cots)


def _hold_on_card(kernel, plain, ins, wrappers):
    """A kernel function against its plain version on CUDA tensors: outputs
    and gradients close, two backward runs equal in every bit, and each of
    the two ``wrappers`` (forward, backward) launched once per call."""
    before = [w.launches for w in wrappers]
    o1, g1 = _grads(kernel, ins)
    _, g2 = _grads(kernel, ins)
    ow, gw = _grads(plain, ins)
    assert [w.launches - n for w, n in zip(wrappers, before)] == [2, 2]
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    for a, b in zip(o1 + g1, ow + gw):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,E,d,H", [(3, 136, 300, 96, 4),
                                       (2, 200, 70, 80, 2),
                                       (2, 512, 1024, 96, 8),
                                       (2, 520, 600, 80, 4),
                                       (3, 520, 1000, 96, 4),
                                       (2, 200, 300, 128, 4),
                                       (2, 136, 200, 128, 2)])
def test_cuda_long_graph_kernels_match_plain(cuda_device, B, N, E, d, H):
    """On the card: both kernels through autograd against their plain
    versions on the same CUDA tensors (stray endpoints, a graph with no real
    node, heads of 12 to 64 columns, multiples of 8 or not, N no multiple of
    the 64-row tiles, dropout off and on). Run it where there is a
    card, from the repository root (the card machine has no JAX, so skip
    ``tests/conftest.py``; this file imports JAX inside its CPU tests only):
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_wide.py``."""
    from graphgps_torch.ops.kernels import edge_gate as eg
    from graphgps_torch.ops.kernels import wide_attention as wa

    dev = cuda_device
    pd, peb, ce, s, r, em = (torch.from_numpy(a).to(dev) for a in
                             _edge_gate_inputs(B, N, E, d, 3, stray=True))
    _hold_on_card(lambda *a: eg.fused_edge_gate(*a, s, r, em),
                  lambda *a: eg.edge_gate_plain(*a, s, r, em), [pd, peb, ce],
                  (eg.fused_edge_gate, eg.edge_gate_backward))

    x, counts, wqkv3, bqkv2, wo, bo = _attn_inputs(B, N, d, 7)
    ins = [torch.from_numpy(a).to(dev) for a in
           (x, wqkv3.reshape(d, 3 * d), bqkv2.reshape(3 * d), wo, bo)]
    tc = torch.from_numpy(counts).to(dev)
    for rate in (0.0, 0.5):
        conf = (device_seed(SEED, dev), H, 1.0 / float(d // H) ** 0.5,
                rate)
        _hold_on_card(
            lambda x_, *w: wa.fused_wide_attention(x_, tc, *w, *conf),
            lambda x_, *w: wa.wide_attention_plain(x_, tc, *w, *conf), ins,
            (wa.fused_wide_attention, wa.wide_attention_backward))


# ---------------------------------------------------------------------------
# the GPS layer on wide graphs

class Rungs:
    """Counts the JAX package's calls of its edge-gate kernel and of its
    small-graph core, and hands its dense attention the port's mask."""

    def __init__(self, monkeypatch):
        import jax.numpy as jnp
        from graphgps_tpu.ops import mha as jmha
        from graphgps_tpu.ops.pallas import fused_edge_gate, fused_gatedgcn
        from graphgps_torch.models import gps_layer
        from graphgps_torch.ops.kernels.common import drop_bits

        self.edge_gate = self.core = self.attn = 0
        real_gate = fused_edge_gate.fused_edge_gate_spmd
        real_core = fused_gatedgcn.fused_gatedgcn_padded

        def gate(*a):
            self.edge_gate += 1
            return real_gate(*a)

        def core(*a):
            self.core += 1
            return real_core(*a)

        def keep_mask_u8(rng, rate, shape):
            self.attn += 1
            t = min(max(int(round(rate * 256)), 1), 255)
            rows = int(np.prod(shape[:-1]))
            b = drop_bits(ATTN_SEED, 0, rows, shape[-1]).numpy()
            return jnp.asarray(((b & 255) >= t).reshape(shape)), 1.0 - t / 256.0

        monkeypatch.setattr(fused_edge_gate, "fused_edge_gate_spmd", gate)
        monkeypatch.setattr(fused_gatedgcn, "fused_gatedgcn_padded", core)
        monkeypatch.setattr(jmha, "keep_mask_u8", keep_mask_u8)
        monkeypatch.setattr(gps_layer, "draw_seeds",
                            lambda gen, n: [1, ATTN_SEED, 3, 4][:n])


@pytest.mark.parametrize("N,train", [(256, True), (136, True), (256, False)])
def test_wide_layer_matches_jax(monkeypatch, N, train):
    """One GPS layer at d = 96, 4 heads, dropout 0 and attention dropout 0.5
    (the VOC rates) on 6 graphs of N node slots and 512 edge slots: the JAX
    layer takes its edge-gate kernel (no block of the small-graph core fits)
    and its dense attention; the port takes the edge gate at N = 256 and the
    core at N = 136, and the wide attention at both. Outputs, and in
    training the gradients of x, e and every parameter and the updated
    running statistics."""
    import jax
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer
    from graphgps_torch.models import local_gnn
    from graphgps_torch.models.gps_layer import GPSLayer
    from graphgps_torch.weights import gps_layer_state_dict, to_torch
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_layer import randomize_norms, torch_batch

    rungs = Rungs(monkeypatch)
    d, H = 96, 4
    batch, x, e, *_ = _blocked_batch(6, N, 512, d, seed=5)
    jl = JaxGPSLayer(dim_h=d, local_gnn_type="CustomGatedGCN",
                     global_model_type="Transformer", num_heads=H,
                     batch_norm=True, act="relu", dropout=0.0,
                     attn_dropout=0.5)
    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=4)
    rungs.edge_gate = rungs.core = 0
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32)
            for a in (x, e)]

    def f(p, x, e):
        out, mut = jl.apply({"params": p, "batch_stats": stats}, batch, x, e,
                            train, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return out, mut.get("batch_stats", stats)

    (jxo, jeo), vjp, jstats = jax.vjp(f, params, x, e, has_aux=True)
    assert rungs.edge_gate == 1 and rungs.core == 0
    assert rungs.attn == (1 if train else 0)

    layer = GPSLayer(d, H, act="relu", dropout=0.0, attn_dropout=0.5)
    layer.train(train)
    assert not layer.holds_front and not layer.defer
    assert (N > local_gnn.CORE_MAX_NODES) == (N == 256)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx, te = (torch.from_numpy(np.array(a)).requires_grad_() for a in (x, e))
    txo, teo = layer(torch_batch(batch), tx, te,
                     torch.Generator().manual_seed(0))
    _close(txo, jxo, "x", 1e-4, 1e-4)
    _close(teo, jeo, "e", 1e-4, 1e-4)
    assert (txo.detach().numpy()[~np.asarray(batch.node_mask)] == 0).all()
    if not train:
        return
    jgp, jgx, jge = vjp(tuple(cots))
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((txo, teo), [tx, te, *layer.parameters()],
                                [torch.from_numpy(c) for c in cots])
    _close(grads[0], jgx, "dx", 1e-4, 1e-4)
    _close(grads[1], jge, "de", 1e-4, 1e-4)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[2:]):
        _close(g, want_g[name], f"d{name}", 1e-4, 1e-4)
    want_s = gps_layer_state_dict(params, jax.device_get(jstats))
    got_s = layer.state_dict()
    for k in want_s:
        if k.endswith(("running_mean", "running_var")):
            _close(got_s[k], want_s[k], k, 1e-4, 1e-4)


def test_layer_refuses_graphs_beyond_the_wide_kernel(monkeypatch):
    """Beyond the wide kernel's 768 node slots the layer no longer refuses:
    it takes JAX's mha dispatch (``ops/mha.py`` ``mha_dispatch``). At 776
    slots that is the dense rung, and the chunked rung forced in its place
    (a ragged last chunk of 8 keys) gives the same output."""
    from graphgps_torch.models.gps_layer import WIDE_MAX_NODES, GPSLayer
    from graphgps_torch.ops import chunked_mha, mha
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_layer import torch_batch

    batch, x, e, *_ = _blocked_batch(1, WIDE_MAX_NODES + 8, 8, 64, seed=1)
    args = (torch_batch(batch), torch.from_numpy(np.array(x)),
            torch.from_numpy(np.array(e)))
    calls = []
    real = chunked_mha.chunked_mha
    monkeypatch.setattr(chunked_mha, "chunked_mha",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    torch.manual_seed(0)
    layer = GPSLayer(64, 4).eval()
    with torch.no_grad():
        dense = layer(*args)
        assert calls == []
        monkeypatch.setattr(mha, "DENSE_MAX_N", 0)
        chunked = layer(*args)
    assert calls == [1]
    for a, b in zip(chunked, dense):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
