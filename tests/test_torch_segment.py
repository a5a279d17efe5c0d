"""The port's segment sums (``graphgps_torch/ops/kernels/segment_sum.py``:
the CSR and tiled wrappers of one CUDA kernel) and the rungs of its
``segment_sum`` and ``gather`` (``graphgps_torch/ops/segment.py``), against
the JAX package on the CPU.

The CSR wrapper's plain version against JAX's ``_segment_sum_csr_fwd_impl``
in interpret mode on ``tests/test_segment_csr.py``'s cases, empty segments
and an edge count off the 1,024 grid, with the gradient against JAX's
``_bwd`` (a take); the tiled wrapper's against JAX's ``tiled_segment_sum``
(interpret mode off the TPU) on ``tests/test_segment_tiled.py``'s four
cases, forward and ``jax.grad``; the rung the port picks against the one
JAX takes, over a grid of sizes and switches, with every JAX rung's function
spied on (JAX's backend read as the TPU where the port is on the card); and
``GCNLayer`` under ``GGPS_TILED_SEGMENT=1 GGPS_TILED_FORCE=1`` in both
packages, with both packages' tiled rungs seen taken by the aggregation and
by the gather's backward. The ``cuda`` cases hold the kernel against its
plain version on the card. JAX is imported inside the tests that use it, so
the card-only tests run on a machine without it.

Tolerance, f32: rtol 1e-5, atol 1e-5 × the tensor's largest entry (sums in
another order); the layer rtol = atol 1e-4 (a matmul, rsqrt and two sums)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _case(E, S, d, seed, skew=False, empty_frac=0.0):
    """``tests/test_segment_tiled.py``'s inputs: (data (E, d), ids (E,))."""
    rng = np.random.default_rng(seed)
    if skew:
        p = 1.0 / np.arange(1, S + 1)
        p /= p.sum()
        ids = rng.choice(S, size=E, p=p)
    else:
        hi = max(int(S * (1.0 - empty_frac)), 1)
        ids = rng.integers(0, hi, size=E)
    data = rng.standard_normal((E, d)).astype(np.float32)
    return data, ids.astype(np.int32)


# (E, S, d, all edges into one segment): tests/test_segment_csr.py's two
# cases and its empty segments, then E off the 1,024 grid
CSR_CASES = [(600, 256, 8, False), (1024, 128, 16, False),
             (128, 128, 8, True), (1500, 384, 24, False)]


@pytest.mark.parametrize("E,S,d,one", CSR_CASES)
def test_csr_plain_matches_jax(E, S, d, one):
    """The CSR sums against JAX's kernel in interpret mode, and the
    gradient against JAX's ``_bwd`` (the take); the row pointers equal
    JAX's ``row_ptr_from_sorted``."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import segment_csr as jcsr
    from graphgps_torch.ops.kernels.segment_sum import (row_ptr_from_sorted,
                                                        segment_sum_csr)

    data, ids = _case(E, S, d, seed=E + S)
    ids = np.full(E, 5, np.int32) if one else np.sort(ids)
    jptr = jcsr.row_ptr_from_sorted(jnp.asarray(ids), S)
    want = jcsr._segment_sum_csr_fwd_impl(jnp.asarray(data), jnp.asarray(ids),
                                          jptr, S, interpret=True)
    tids = torch.from_numpy(ids)
    ptr = row_ptr_from_sorted(tids, S)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr))
    x = torch.from_numpy(data).requires_grad_()
    got = segment_sum_csr(x, tids, ptr, S)
    _close(got, want, "sums")
    if one:
        assert not got.detach()[torch.arange(S) != 5].any()
    g = np.random.default_rng(1).standard_normal((S, d)).astype(np.float32)
    (gx,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    np.testing.assert_array_equal(
        gx.numpy(), np.asarray(jcsr._bwd(S, jnp.asarray(ids),
                                         jnp.asarray(g))[0]))


def test_csr_refuses_unsorted_receivers():
    from graphgps_torch.ops.kernels.segment_sum import (row_ptr_from_sorted,
                                                        segment_sum_csr)

    data, ids = _case(300, 128, 8, seed=3)
    tids = torch.from_numpy(ids)
    with pytest.raises(ValueError, match="receivers must be sorted"):
        segment_sum_csr(torch.from_numpy(data), tids,
                        row_ptr_from_sorted(tids.sort().values, 128), 128)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_loader_batches_sort_receivers(batch_size):
    """The CSR rung's one caller, ``GCNLayer``'s aggregation, sums over the
    loader's ``batch.receivers``: every batch, padded graph slots and padded
    edges included, carries them sorted, from graphs whose edges are not."""
    from graphgps_torch.data.graph import Graph
    from graphgps_torch.data.loader import DeviceLoader

    rng = np.random.default_rng(11)
    graphs = []
    for n in (5, 9, 1, 7, 12):
        e = int(rng.integers(1, 3 * n + 1))
        graphs.append(Graph(
            node_feat=rng.standard_normal((n, 4)).astype(np.float32),
            edge_index=rng.integers(0, n, size=(2, e)).astype(np.int64)))
    loader = DeviceLoader(graphs, batch_size, "cpu", shuffle=True, seed=3)
    for _ in range(2):
        for _real, b in loader:
            r = b.receivers
            assert bool((r[1:] >= r[:-1]).all())


TILED_CASES = [(2048, 1024, 64, False, 0.0), (2048, 1024, 64, False, 0.5),
               (4096, 512, 128, True, 0.0), (1000, 248, 32, False, 0.0)]


@pytest.mark.parametrize("E,S,d,skew,empty", TILED_CASES)
def test_tiled_plain_matches_jax(E, S, d, skew, empty):
    """The tiled sums (unsorted ids, half the segments empty, hubs, an odd
    S) against JAX's ``tiled_segment_sum`` in interpret mode, and the
    gradient of a weighted sum against ``jax.grad``'s."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.segment_tiled import tiled_segment_sum as jt
    from graphgps_torch.ops.kernels.segment_sum import tiled_segment_sum

    data, ids = _case(E, S, d, seed=E + S, skew=skew, empty_frac=empty)
    w = np.random.default_rng(2).standard_normal((S, d)).astype(np.float32)
    jids = jnp.asarray(ids)
    want = jt(jnp.asarray(data), jids, S)
    want_g = jax.grad(lambda a: jnp.sum(jt(a, jids, S) * w))(
        jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = tiled_segment_sum(x, torch.from_numpy(ids), S)
    _close(got, want, "sums")
    (gx,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    _close(gx, want_g, "grad")


# ---------------------------------------------------------------------------
# the rungs

class JaxRungs:
    """Spies on every rung of JAX's ``segment_sum``; the tiled and CSR
    kernels are replaced by zeros of their shape (the TPU kernels do not run
    here), the others run. ``taken`` lists the rungs in call order."""

    def __init__(self, monkeypatch, backend: str):
        import jax
        import jax.numpy as jnp
        from graphgps_tpu.ops import segment as jseg
        from graphgps_tpu.ops.pallas import segment_csr, segment_tiled

        self.taken = []
        real_blocked, real_onehot = jseg.blocked_segment_sum, jseg._onehot
        real_scatter = jax.ops.segment_sum

        def blocked(*a, **k):
            self.taken.append("blocked")
            return real_blocked(*a, **k)

        def onehot(*a, **k):
            self.taken.append("dense")
            return real_onehot(*a, **k)

        def tiled(data, ids, S):
            self.taken.append("tiled")
            return jnp.zeros((S, data.shape[1]), data.dtype)

        def csr(data, receivers, row_ptr, S):
            self.taken.append("csr")
            return jnp.zeros((S, data.shape[1]), data.dtype)

        def scatter(*a, **k):
            self.taken.append("scatter")
            return real_scatter(*a, **k)

        monkeypatch.setattr(jseg, "blocked_segment_sum", blocked)
        monkeypatch.setattr(jseg, "_onehot", onehot)
        monkeypatch.setattr(segment_tiled, "tiled_segment_sum", tiled)
        monkeypatch.setattr(segment_csr, "segment_sum_csr", csr)
        monkeypatch.setattr(jax.ops, "segment_sum", scatter)
        monkeypatch.setattr(jax, "default_backend", lambda: backend)


# (E, S, d or None for 1-D data, edge_block, max_nodes)
RUNG_SHAPES = [
    (4096, 512, 16, None, None),          # dense: E*S = 2^21
    (4096, 512, 16, 128, 16),             # blocked: 32 graphs of 16 slots
    (16384, 1024, 16, 16384, 1024),       # too wide to block: tiled or CSR
    (16384, 1024, None, None, None),      # 1-D data (degrees): scatter
    (16384, 1000, 32, None, None),        # S off the 128 grid: tiled only
    (20000, 5248, 96, None, None),        # wn-squirrel's width
    (16384, 1024, 8, None, None),         # d < 16: CSR or scatter
    (12000, 1024, 32, None, None),        # E < 16,384: CSR or scatter
]
SWITCHES = [{}, {"GGPS_TILED_SEGMENT": "1"},
            {"GGPS_TILED_SEGMENT": "1", "GGPS_TILED_FORCE": "1"},
            {"GGPS_USE_CSR_KERNEL": "1"},
            {"GGPS_TILED_SEGMENT": "1", "GGPS_USE_CSR_KERNEL": "1"}]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("switches", range(len(SWITCHES)))
def test_rung_choice_matches_jax(monkeypatch, device, switches):
    """Over sizes, layouts and JAX's switches: the rung the port's
    ``segment_rung`` names is the one JAX's ``segment_sum`` takes, with
    JAX's backend read as the TPU for the port's card; and the port's
    ``segment_sum`` on the CPU takes it (the CSR rung never)."""
    import jax.numpy as jnp
    from graphgps_tpu.ops import segment as jseg
    from graphgps_torch.ops import segment
    from graphgps_torch.ops.kernels import segment_sum as kseg

    for key in ("GGPS_TILED_SEGMENT", "GGPS_TILED_FORCE",
                "GGPS_USE_CSR_KERNEL"):
        monkeypatch.delenv(key, raising=False)
    for key, val in SWITCHES[switches].items():
        monkeypatch.setenv(key, val)
    spies = JaxRungs(monkeypatch, "tpu" if device == "cuda" else "cpu")
    port_tiled = []
    real = kseg.tiled_segment_sum
    monkeypatch.setattr(kseg, "tiled_segment_sum", lambda *a: (
        port_tiled.append(1), real(*a))[1])
    rng = np.random.default_rng(0)
    for E, S, d, eb, mn in RUNG_SHAPES:
        shape = (E,) if d is None else (E, d)
        ids = np.sort(rng.integers(0, S, E)).astype(np.int32)
        if eb:   # each graph's edges inside its node range
            ids = (np.arange(E) // eb * mn + ids % mn).astype(np.int32)
        data = np.zeros(shape, np.float32)
        spies.taken.clear()
        jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), S,
                         edge_block=eb, max_nodes=mn)
        assert len(spies.taken) == 1
        want = spies.taken[0]
        got = segment.segment_rung(shape, True, S, device, eb, mn)
        assert got == want, (E, S, d, eb, SWITCHES[switches], device)
        if device == "cpu":
            port_tiled.clear()
            segment.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                                S, edge_block=eb, max_nodes=mn)
            assert len(port_tiled) == (want == "tiled")
    # integer data: JAX's scatter, whatever the switches
    assert segment.segment_rung((16384, 32), False, 1024, device) == "scatter"


def test_has_nb_matches_jax():
    from graphgps_tpu.ops.pallas.segment_tiled import _pick_nb
    from graphgps_torch.ops.segment import has_nb

    for S in (248, 512, 1000, 5248, 80000, 7, 4099, 8, 4, 1021 * 8):
        assert has_nb(S) == (_pick_nb(S) is not None), S


def _gcn_batch(seed=4):
    """One graph of 1,024 node slots and 16,384 edge slots: too wide for the
    blocked and dense rungs, within the tiled one's (E ≥ 16,384, S ≥ 512)."""
    from tests.test_fused_gatedgcn import _blocked_batch

    return _blocked_batch(1, 1024, 16384, 64, seed=seed)


def test_gcn_layer_tiled_matches_jax(monkeypatch):
    """``GCNLayer`` forward and the gradients of x and its weights under
    ``GGPS_TILED_SEGMENT=1 GGPS_TILED_FORCE=1`` in both packages: each took
    the tiled rung once in the aggregation and once in the gather's
    backward, and the port agrees with JAX."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.models.local_gnn import GCNLayer as JaxGCN
    from graphgps_tpu.ops.pallas import segment_tiled
    from graphgps_torch.models.local_gnn import GCNLayer
    from graphgps_torch.ops.kernels import segment_sum as kseg
    from tests.test_torch_layer import torch_batch

    monkeypatch.setenv("GGPS_TILED_SEGMENT", "1")
    monkeypatch.setenv("GGPS_TILED_FORCE", "1")
    jcalls, tcalls = [], []
    jreal, treal = segment_tiled.tiled_segment_sum, kseg.tiled_segment_sum

    def jspy(data, ids, S):
        jcalls.append(data.shape)
        return jreal(data, ids, S)

    def tspy(data, ids, S):
        tcalls.append(tuple(data.shape))
        return treal(data, ids, S)

    monkeypatch.setattr(segment_tiled, "tiled_segment_sum", jspy)
    monkeypatch.setattr(kseg, "tiled_segment_sum", tspy)
    batch, x, *_ = _gcn_batch()
    jl = JaxGCN(dim=64)
    var = jl.init(jax.random.PRNGKey(1), batch, x, None, False)
    jcalls.clear()
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        return jl.apply({"params": p}, batch, x, None, False)[0]

    want, vjp = jax.vjp(f, var["params"], x)
    jgp, jgx = vjp(jnp.asarray(cot))
    # the forward aggregation, and the gather's backward
    assert [tuple(s) for s in jcalls] == [(16384, 64)] * 2

    layer = GCNLayer(64)
    dense = var["params"]["Dense_0"]
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(np.array(dense["kernel"])))
        layer.b.copy_(torch.from_numpy(np.array(dense["bias"])))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    out, _ = layer(torch_batch(batch), tx, None)
    assert tcalls == [(16384, 64)]
    gx, gw, gb = torch.autograd.grad(out, [tx, layer.w, layer.b],
                                     torch.from_numpy(cot))
    assert tcalls == [(16384, 64)] * 2
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(out, want, "gcn", **tol)
    _close(gx, jgx, "dx", **tol)
    _close(gw, jgp["Dense_0"]["kernel"], "dw", **tol)
    _close(gb, jgp["Dense_0"]["bias"], "db", **tol)


def test_gather_backward_rungs(monkeypatch):
    """The gather's backward: the tiled rung only where JAX's ``_sbt_bwd``
    takes it (4,096 indices or more, not blocked, ``GGPS_SORTED_TAKE`` not
    0, and the tiled conditions), ``index_add_`` otherwise; the gradient is
    the same either way."""
    from graphgps_torch.ops import segment
    from graphgps_torch.ops.kernels import segment_sum as kseg

    calls = []
    real = kseg.tiled_segment_sum
    monkeypatch.setattr(kseg, "tiled_segment_sum",
                        lambda *a: (calls.append(1), real(*a))[1])
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((1024, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 1024, 16384).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((16384, 32)).astype(np.float32))
    want = torch.zeros(1024, 32).index_add_(0, idx.long(), g)

    def grad(**kw):
        x = x0.clone().requires_grad_()
        return torch.autograd.grad(segment.gather(x, idx, **kw), x, g)[0]

    on = {"GGPS_TILED_SEGMENT": "1", "GGPS_TILED_FORCE": "1"}
    for env, kw, tiled in (({}, {}, False), (on, {}, True),
                           ({**on, "GGPS_SORTED_TAKE": "0"}, {}, False),
                           # 32 graphs of 32 node slots: the blocked gather
                           (on, dict(edge_block=512, max_nodes=32), False)):
        for key in ("GGPS_TILED_SEGMENT", "GGPS_TILED_FORCE",
                    "GGPS_SORTED_TAKE"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        calls.clear()
        torch.testing.assert_close(grad(**kw), want, rtol=1e-5, atol=1e-5)
        assert len(calls) == tiled, env


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    """Decided inside the fixture, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_ids(E, S, kind, seed):
    """ids (E,) int32 of a card case: "uniform" or "skew" (a power law over
    the S segments, a hub first), "one" (every edge in segment S // 2), or
    "task_len" (segments of C - 1, C, C + 1, 2C, 2C + 1 and 3 edges for
    C = TASK_LEN between empty ones, the first and last segments empty;
    E is then theirs); shuffled."""
    from graphgps_torch.ops.kernels.segment_sum import TASK_LEN as C

    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.full(E, S // 2, np.int32)
    if kind == "task_len":
        lengths = np.zeros(S, np.int64)
        lengths[1:12:2] = [C - 1, C, C + 1, 2 * C, 2 * C + 1, 3]
        ids = np.repeat(np.arange(S), lengths)
        return rng.permutation(ids).astype(np.int32)
    return _case(E, S, 1, seed, skew=kind == "skew")[1]


# (E, S, d, kind): wn-squirrel's aggregation width uniform and with hubs, a
# width off the float4 grid, MalNet's size uniform and with hubs, one
# segment holding every edge, segments of C and C +- 1 edges with empty
# first and last segments (d 96 and the scalar path's d 30), no edge at all
CARD_CASES = [(41600, 5248, 96, "uniform"), (41600, 5248, 96, "skew"),
              (3000, 1000, 30, "uniform"), (313000, 80000, 64, "uniform"),
              (313000, 80000, 64, "skew"), (41600, 5248, 96, "one"),
              (None, 64, 96, "task_len"), (None, 64, 30, "task_len"),
              (0, 128, 96, "uniform")]


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,d,kind", CARD_CASES)
def test_cuda_segment_sums_match_plain(cuda_device, E, S, d, kind):
    """On the card: both wrappers against their plain versions on the same
    CUDA tensors (hub segments split across warps, a width off the float4
    grid, MalNet's size, one segment holding every edge, segments of C and
    C +- 1 edges, empty end segments, no edge), two runs equal in every
    bit, the gradient the gather, one launch per call, each plan's kernel
    equal to its plain version and its tickets back at 0. Run it from the
    repository root: ``python -m pytest --noconftest -o addopts="" -p
    no:cacheprovider -m cuda tests/test_torch_segment.py``."""
    from graphgps_torch.ops.kernels import segment_sum as kseg

    ids = _card_ids(E, S, kind, seed=7)
    E = ids.shape[0]
    data = np.random.default_rng(8).standard_normal((E, d)).astype(np.float32)
    x = torch.from_numpy(data).to(cuda_device)
    tids = torch.from_numpy(ids).to(cuda_device)
    sids = tids.sort().values
    ptr = kseg.row_ptr_from_sorted(sids, S)
    for wrapper, plain, args in (
            (kseg.tiled_segment_sum, kseg.tiled_segment_sum_plain, (tids, S)),
            (kseg.segment_sum_csr, kseg.segment_sum_csr_plain,
             (sids, ptr, S))):
        before = wrapper.launches
        got, again = wrapper(x, *args), wrapper(x, *args)
        assert wrapper.launches - before == 2
        assert torch.equal(got, again)
        want = plain(x, *args)
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=ATOL * float(want.abs().max()))
        leaf = x.clone().requires_grad_()
        g = torch.randn(S, d, device=cuda_device)
        (gx,) = torch.autograd.grad(wrapper(leaf, *args), leaf, g)
        assert torch.equal(gx, g[args[0].long()])
        tiled = wrapper is kseg.tiled_segment_sum
        plan = kseg.plan_for(args[0], S, tiled)
        for a, b in zip((plan.perm, plan.ptr, plan.chunk_seg),
                        kseg.plan_plain(args[0], S, tiled)):
            assert (a is None and b is None) or torch.equal(a, b)
        assert not plan.tickets.any()


@pytest.mark.cuda
def test_cuda_two_plans_alternate(cuda_device):
    """Two id vectors with hub segments (split across warps, so their
    tickets are taken and reset), their plans used in turn by both
    wrappers: every call gives the bits of the first call on its plan."""
    from graphgps_torch.ops.kernels import segment_sum as kseg

    E, S, d = 41600, 5248, 96
    x = torch.from_numpy(_case(E, S, d, seed=11)[0]).to(cuda_device)
    sums = []
    for seed in (12, 13):
        tids = torch.from_numpy(_card_ids(E, S, "skew", seed)).to(cuda_device)
        sids = tids.sort().values
        sums.append((lambda t=tids: kseg.tiled_segment_sum(x, t, S),
                     lambda t=sids: kseg.segment_sum_csr(x, t, None, S)))
    first = [f() for pair in sums for f in pair]
    for _ in range(3):
        again = [f() for pair in sums for f in pair]
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], first[2])


@pytest.mark.cuda
def test_cuda_csr_asserts_sorted_receivers(cuda_device):
    """On the card the CSR wrapper asserts the sort on the device: unsorted
    receivers end the process in a failed device-side assertion. It runs in a process
    of its own, since the assert spoils that process's CUDA context."""
    import pathlib
    import subprocess
    import sys

    code = ("import torch\n"
            "from graphgps_torch.ops.kernels import segment_sum as k\n"
            "ids = torch.tensor([3, 1, 2, 0] * 8, dtype=torch.int32, "
            "device='cuda')\n"
            "k.segment_sum_csr(torch.ones(32, 8, device='cuda'), ids, "
            "k.row_ptr_from_sorted(ids, 128), 128)\n"
            "torch.cuda.synchronize()\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    # the device's assertion message, then the next launch's error
    assert run.returncode != 0
    assert "Assertion" in run.stderr, run.stderr[-2000:]
