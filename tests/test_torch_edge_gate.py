"""The long-graph edge gate's per-batch edge orders, and on the card the
edge-gate kernels over them.

On the CPU: the orders' plain version (``edge_gate_orders`` on CPU tensors)
against a numpy stable sort of the ids ``g*N + endpoint`` and the CSR
offsets of the sorted ids, with stray endpoints (the sink segment), a hub
receiver and a graph with no real edge; a batch builds its orders once,
shares them across the layers' forward and backward calls, and a new batch
builds its own; orders of other endpoints, or of endpoints edited since,
are refused.

On the card (``cuda`` marker, skipped without one): the kernels against
their plain versions at VOC's shape (32 graphs of 512 node slots, 1,024 and
3,072 edge slots, d = 96), on a batch with a hub receiver (a third of a
graph's edges into one node), a graph with no real edge and stray
endpoints, and on graphs of 1,024 node slots (more than the 900 the
shared-memory kernel before these orders took); the orders' plan kernel
against their plain version; two backward runs equal in every bit. Runs
without JAX or this directory's conftest:
``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
tests/test_torch_edge_gate.py``.

Tolerance of the card cases, f32: rtol 1e-4, atol 1e-5 × the tensor's
largest entry (``chip_smoke.py``'s LONG_RTOL, LONG_ATOL: the plain version
sums by ``index_add`` in another order)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _endpoints(B, N, E, seed, kind="uniform"):
    """(s_loc, r_loc, emask) int32/int32/float32 numpy (B, E): receivers
    sorted per graph as the loader sorts them. ``kind``: "uniform"; "hub"
    (a third of graph 0's edges into node 5); "empty" (graph 1 has no real
    edge: its slots point at node 0, masked); "stray" (endpoints outside
    [0, N): every 7th sender, every 5th receiver)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, (B, E)).astype(np.int32)
    r = rng.integers(0, N, (B, E)).astype(np.int32)
    em = (rng.random((B, E)) < 0.9).astype(np.float32)
    if kind == "hub":
        r[0, rng.permutation(E)[:E // 3]] = 5
    if kind == "empty":
        s[1], r[1], em[1] = 0, 0, 0.0
    r = np.sort(r, axis=1).astype(np.int32)
    if kind == "stray":
        s[:, ::7] = N + 3
        r[:, ::5] = -1
    return s, r, em


def _numpy_order(loc, N):
    """(perm, ptr) of a numpy stable sort of g*N + loc (B*N outside)."""
    B, E = loc.shape
    ids = np.where((loc >= 0) & (loc < N), loc + N * np.arange(B)[:, None],
                   B * N).reshape(-1)
    perm = np.argsort(ids, kind="stable")
    ptr = np.searchsorted(ids[perm], np.arange(B * N + 1), side="left")
    return perm, ptr


@pytest.mark.parametrize("kind", ["uniform", "hub", "empty", "stray"])
def test_orders_plain_match_numpy(kind):
    """Both orders, perm and CSR offsets, against numpy; the sink segment
    (ptr[B*N] to the end) holds exactly the stray endpoints' edges."""
    from graphgps_torch.ops.kernels.edge_gate import edge_gate_orders

    B, N, E = 3, 40, 96
    s, r, _ = _endpoints(B, N, E, 7, kind)
    orders = edge_gate_orders(torch.from_numpy(s), torch.from_numpy(r), N)
    assert orders.perm.dtype == orders.plan.ptr.dtype == torch.int32
    for by_sender, loc in ((False, r), (True, s)):
        got_perm, got_ptr = orders.order(by_sender)
        perm, ptr = _numpy_order(loc, N)
        np.testing.assert_array_equal(got_perm.numpy(), perm)
        np.testing.assert_array_equal(got_ptr.numpy(), ptr)
        stray = int(((loc < 0) | (loc >= N)).sum())
        assert B * E - int(got_ptr[B * N]) == stray
    # the kernels' joint arrays: the sender order after the receivers'
    np.testing.assert_array_equal(orders.recv_ptr.numpy(),
                                  _numpy_order(r, N)[1])
    np.testing.assert_array_equal(orders.send_ptr[:B * N + 1].numpy(),
                                  _numpy_order(s, N)[1] + B * E)
    if kind == "hub":
        assert int(orders.recv_ptr[6] - orders.recv_ptr[5]) >= E // 3


def _batch(B, N, E, seed, kind="uniform"):
    """A GraphBatch of B graphs in N node and E edge slots (all nodes real)
    with ``_endpoints``' edges."""
    from graphgps_torch.data.graph import GraphBatch

    s, r, em = _endpoints(B, N, E, seed, kind)
    base = (N * np.arange(B, dtype=np.int32))[:, None]
    return GraphBatch(
        node_feat=torch.zeros(B * N, 1), edge_feat=None,
        senders=torch.from_numpy((s + base).reshape(-1)),
        receivers=torch.from_numpy((r + base).reshape(-1)),
        node_mask=torch.ones(B * N, dtype=torch.bool),
        edge_mask=torch.from_numpy(em.reshape(-1) > 0),
        graph_mask=torch.ones(B, dtype=torch.bool), y=None, pe={},
        num_graphs=B, max_nodes=N, edge_block=E)


def test_orders_built_once_per_batch(monkeypatch):
    """Two GatedGCN layers on the long-graph rung, forward and backward, on
    one batch build its orders once; the next batch builds its own (a new
    object, of its own endpoints): no plan outlives its batch."""
    from graphgps_torch.models.local_gnn import GatedGCNLayer
    from graphgps_torch.ops.kernels import edge_gate
    from graphgps_torch.ops.kernels.gatedgcn import MAX_NODES

    built = []
    real = edge_gate.edge_gate_orders

    def counted(*a):
        built.append(real(*a))
        return built[-1]

    monkeypatch.setattr(edge_gate, "edge_gate_orders", counted)
    B, N, E, d = 2, MAX_NODES + 19, 300, 16
    torch.manual_seed(0)
    layers = [GatedGCNLayer(d, own_node_proj=True) for _ in range(2)]
    for step, seed in enumerate((1, 2)):
        batch = _batch(B, N, E, seed)
        x = torch.randn(B * N, d, requires_grad=True)
        e = torch.randn(B * E, d)
        h, g = x, e
        for layer in layers:
            xo, gate, _, _ = layer.core(batch, h, g)
            h, g = h + xo, g + gate
        (h.square().sum() + g.square().sum()).backward()
        assert len(built) == step + 1
        assert batch.edge_gate_orders is built[-1]
        assert built[-1].fits(*batch.front_index[:2], N)
    assert built[0] is not built[1]
    assert not torch.equal(built[0].recv_ptr, built[1].recv_ptr)


def test_stale_or_foreign_orders_refused():
    """Orders of another batch's endpoints, or of endpoints edited in place
    after the orders were built, raise; the batch's own pass."""
    from graphgps_torch.ops.kernels.edge_gate import fused_edge_gate

    B, N, E, d = 2, 30, 50, 8
    a, b = _batch(B, N, E, 1), _batch(B, N, E, 2)
    s, r, em, _ = a.front_index
    g = torch.Generator().manual_seed(0)
    ins = (torch.randn(B, N, d, generator=g),
           torch.randn(B, N, 2 * d, generator=g),
           torch.randn(B, E, d, generator=g))
    fused_edge_gate(*ins, s, r, em, orders=a.edge_gate_orders)
    with pytest.raises(ValueError, match="orders"):
        fused_edge_gate(*ins, s, r, em, orders=b.edge_gate_orders)
    orders = a.edge_gate_orders
    r[0, 0] = (r[0, 0] + 1) % N
    with pytest.raises(ValueError, match="orders"):
        fused_edge_gate(*ins, s, r, em, orders=orders)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,E,d,kind", [(32, 512, 1024, 96, "uniform"),
                                          (32, 512, 3072, 96, "uniform"),
                                          (8, 512, 1024, 96, "hub"),
                                          (8, 512, 1024, 96, "empty"),
                                          (8, 512, 1024, 96, "stray"),
                                          (4, 1024, 2048, 96, "uniform"),
                                          (3, 1100, 700, 40, "stray"),
                                          (2, 600, 900, 200, "hub")])
def test_cuda_edge_gate_matches_plain(cuda_device, B, N, E, d, kind):
    """On the card: the orders' plan kernel against their plain version;
    the forward and backward kernels over the batch's orders against the
    plain versions (autograd); two runs equal in every bit; one plan
    launch for both orders, one launch of each kernel a call."""
    from graphgps_torch.ops.kernels import edge_gate as eg
    from graphgps_torch.ops.kernels.segment_sum import segment_plan

    dev = cuda_device
    s, r, em = (torch.from_numpy(a).to(dev)
                for a in _endpoints(B, N, E, N + E, kind))
    before = segment_plan.launches
    orders = eg.edge_gate_orders(s, r, N)
    assert segment_plan.launches == before + 1
    plain = eg.edge_gate_orders(s.cpu(), r.cpu(), N)
    assert torch.equal(orders.perm.cpu(), plain.perm)
    assert torch.equal(orders.plan.ptr.cpu(), plain.plan.ptr)
    g = torch.Generator(device=dev).manual_seed(B + N)
    ins = [torch.randn(sh, generator=g, device=dev)
           for sh in ((B, N, d), (B, N, 2 * d), (B, E, d))]
    cots = [torch.randn(sh, generator=g, device=dev)
            for sh in ((B, E, d), (B, N, 2 * d))]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, cots)

    launches = eg.fused_edge_gate.launches, eg.edge_gate_backward.launches
    o1, g1 = run(lambda *a: eg.fused_edge_gate(*a, s, r, em, orders=orders))
    o2, g2 = run(lambda *a: eg.fused_edge_gate(*a, s, r, em, orders=orders))
    assert (eg.fused_edge_gate.launches - launches[0],
            eg.edge_gate_backward.launches - launches[1]) == (2, 2)
    assert segment_plan.launches == before + 1
    ow, gw = run(lambda *a: eg.edge_gate_plain(*a, s, r, em))
    for a, b in zip(o1 + g1, o2 + g2):
        assert torch.equal(a, b)
    for a, b in zip(o1 + g1, ow + gw):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * max(1.0, float(b.abs().max())))
