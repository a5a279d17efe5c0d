"""The segment sums' plan (``graphgps_torch/ops/kernels/segment_sum.py``
``SegmentPlan``, ``plan_for``, ``plan_plain``, ``segment_tasks``) on the
CPU, where the plan is its plain version.

A plan is built once per id tensor and reused: a three-layer GCN step
under the tiled rung builds the receivers' and the senders' plans (not one
per sum and gather backward), under the CSR rung the receivers' alone; an
in-place edit of the ids or a new batch builds a new one. The plain plan's
pointers and permutation equal JAX's ``row_ptr_from_sorted`` and
``_prep``'s stable argsort on ``tests/test_torch_segment.py``'s case grids,
and the kernel's warp tasks, as ``segment_tasks`` reads them from the plan,
cover each edge once, in order, none over ``task_len`` edges.

Tolerance, f32: rtol 1e-5, atol 1e-5 × the tensor's largest entry (sums in
another order)."""
import numpy as np
import pytest
import torch

from test_torch_segment import CSR_CASES, TILED_CASES, _case, _close

torch.set_num_threads(2)

SWITCHES = ("GGPS_TILED_SEGMENT", "GGPS_TILED_FORCE", "GGPS_USE_CSR_KERNEL")


def _gcn_batch(seed=4):
    """One graph of 1,024 node slots and 16,384 edge slots (the tiled rung's
    sizes), receivers sorted as the loader packs them, a tail of padded
    edges on the last real node."""
    from graphgps_torch.data.graph import GraphBatch

    rng = np.random.default_rng(seed)
    N, E, real_n, real_e = 1024, 16384, 1000, 16000
    snd = rng.integers(0, real_n, E).astype(np.int32)
    rcv = np.sort(rng.integers(0, real_n, E)).astype(np.int32)
    snd[real_e:] = rcv[real_e:] = real_n - 1
    rcv = np.sort(rcv)
    t = torch.from_numpy
    batch = GraphBatch(
        node_feat=torch.zeros(N, 1, dtype=torch.int32), edge_feat=None,
        senders=t(snd), receivers=t(rcv),
        node_mask=torch.arange(N) < real_n, edge_mask=torch.arange(E) < real_e,
        graph_mask=torch.ones(1, dtype=torch.bool), y=None, pe={},
        num_graphs=1, max_nodes=N, edge_block=E)
    x = t(rng.standard_normal((N, 64)).astype(np.float32))
    return batch, x


def _gcn_step(batch, x, layers, train: bool):
    """Three GCN layers' output, and in training the gradient of x."""
    x = x.clone().requires_grad_(train)
    h = x
    for layer in layers:
        h = layer(batch, h, None)[0]
    if not train:
        return h.detach(), None
    return h.detach(), torch.autograd.grad(h.square().sum(), x)[0]


@pytest.mark.parametrize("rung", ["tiled", "csr"])
def test_gcn_step_builds_one_plan_per_id_vector(monkeypatch, rung):
    """A three-layer GCN training step (forward and backward) builds one
    plan per id vector: the tiled rung the receivers' (3 sums) and the
    senders' (3 gather backwards), the CSR rung (the CPU read as the card)
    the receivers' alone; an evaluation step the receivers'. Outputs and
    gradients agree with the default rung's (``index_add_``)."""
    from graphgps_torch.models.local_gnn import GCNLayer
    from graphgps_torch.ops import segment
    from graphgps_torch.ops.kernels import segment_sum as kseg

    torch.manual_seed(0)
    layers = [GCNLayer(64) for _ in range(3)]
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    batch, x = _gcn_batch()
    want, want_g = _gcn_step(batch, x, layers, True)

    built, sums = [], []
    real_plan = kseg.segment_plan
    monkeypatch.setattr(kseg, "segment_plan", lambda ids, *a: (
        built.append(ids), real_plan(ids, *a))[1])
    name = "tiled_segment_sum" if rung == "tiled" else "segment_sum_csr"
    real_sum = getattr(kseg, name)
    monkeypatch.setattr(kseg, name, lambda *a: (sums.append(1),
                                                real_sum(*a))[1])
    if rung == "tiled":
        monkeypatch.setenv("GGPS_TILED_SEGMENT", "1")
        monkeypatch.setenv("GGPS_TILED_FORCE", "1")
    else:
        monkeypatch.setenv("GGPS_USE_CSR_KERNEL", "1")
        real_rung = segment.segment_rung
        monkeypatch.setattr(segment, "segment_rung", lambda shape, fl, S, dev,
                            *a: real_rung(shape, fl, S, "cuda", *a))
    batch, x = _gcn_batch()          # new id tensors: no plan yet
    got, got_g = _gcn_step(batch, x, layers, True)
    if rung == "tiled":
        assert len(sums) == 6
        assert [id(t) for t in built] == [id(batch.receivers),
                                          id(batch.senders)]
    else:
        assert len(sums) == 3
        assert [id(t) for t in built] == [id(batch.receivers)]
    _close(got, want.numpy(), "out")
    _close(got_g, want_g.numpy(), "dx")

    built.clear()
    batch, x = _gcn_batch(seed=5)
    _gcn_step(batch, x, layers, False)
    assert [id(t) for t in built] == [id(batch.receivers)]


@pytest.mark.parametrize("tiled", [True, False])
def test_plan_rebuilt_after_in_place_edit_or_new_ids(monkeypatch, tiled):
    """The plan kept on an id tensor serves every later sum over it, until
    an in-place edit of the ids (a new plan, the new ids' sums) or new ids
    with the same values (a new tensor: a new plan). A plan handed in
    explicitly must be the ids' current one."""
    from graphgps_torch.ops.kernels import segment_sum as kseg

    built = []
    real_plan = kseg.segment_plan
    monkeypatch.setattr(kseg, "segment_plan", lambda ids, *a: (
        built.append(ids), real_plan(ids, *a))[1])
    E, S, d = 2000, 256, 8
    data, ids = _case(E, S, d, seed=9, skew=True)
    if not tiled:
        ids = np.sort(ids)
    x, tids = torch.from_numpy(data), torch.from_numpy(ids)

    def run(t, plan=None):
        if tiled:
            return kseg.tiled_segment_sum(x, t, S, plan=plan)
        return kseg.segment_sum_csr(x, t, None, S, plan=plan)

    def want(t):
        if tiled:
            return kseg.tiled_segment_sum_plain(x, t, S)
        return kseg.segment_sum_csr_plain(x, t, kseg.row_ptr_from_sorted(t, S),
                                          S)

    for _ in range(2):
        _close(run(tids), want(tids).numpy(), "sums")
    assert len(built) == 1
    plan = kseg.plan_for(tids, S, tiled)
    assert len(built) == 1
    new = np.sort(_case(E, S, d, seed=10)[1])
    tids.copy_(torch.from_numpy(new if not tiled else new[::-1].copy()))
    with pytest.raises(ValueError, match="before the ids changed"):
        run(tids, plan)
    _close(run(tids), want(tids).numpy(), "sums after the edit")
    assert len(built) == 2
    copy = tids.clone()
    _close(run(copy), want(copy).numpy(), "sums over new ids")
    assert len(built) == 3 and built[-1] is copy


@pytest.mark.parametrize("E,S,d,one", CSR_CASES)
def test_plain_csr_plan_matches_jax(E, S, d, one):
    """The CSR plan's pointers equal JAX's ``row_ptr_from_sorted``."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import segment_csr as jcsr
    from graphgps_torch.ops.kernels.segment_sum import segment_plan

    _data, ids = _case(E, S, d, seed=E + S)
    ids = np.full(E, 5, np.int32) if one else np.sort(ids)
    plan = segment_plan(torch.from_numpy(ids), S, tiled=False)
    assert plan.perm is None
    np.testing.assert_array_equal(
        plan.ptr.numpy(), np.asarray(jcsr.row_ptr_from_sorted(
            jnp.asarray(ids), S)))


@pytest.mark.parametrize("E,S,d,skew,empty", TILED_CASES)
def test_plain_tiled_plan_matches_jax(E, S, d, skew, empty):
    """The tiled plan's permutation is JAX's ``_prep`` order (a stable
    argsort), and its pointers JAX's ``row_ptr_from_sorted`` of the ids in
    that order."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import segment_csr as jcsr
    from graphgps_tpu.ops.pallas.segment_tiled import _pick_nb, _prep
    from graphgps_torch.ops.kernels.segment_sum import segment_plan

    _data, ids = _case(E, S, d, seed=E + S, skew=skew, empty_frac=empty)
    jperm = np.asarray(_prep(jnp.asarray(ids), S, _pick_nb(S))[0])
    plan = segment_plan(torch.from_numpy(ids), S, tiled=True)
    np.testing.assert_array_equal(plan.perm.numpy(), jperm)
    np.testing.assert_array_equal(
        plan.ptr.numpy(), np.asarray(jcsr.row_ptr_from_sorted(
            jnp.asarray(ids[jperm]), S)))


C = 128
# (segment lengths, S): empty segments inside and at both ends, one segment
# holding every edge, C and C +- 1 edges, several chunks, a segment starting
# on a chunk's first edge, no edge at all; then hub-skewed ids
TASK_CASES = [
    ([0, 3, 0, 0, 7, 1, 0], 7),
    ([0] * 7 + [5000] + [0] * 8, 16),
    ([C - 1, C, C + 1, 1, 2 * C, 2 * C + 1, 3 * C - 1], 7),
    ([0, C + 1, 0, C - 1, 5 * C, 0], 6),
    ([C, C, 3 * C, C + 7, 0, 1], 6),
    ([0] * 5, 5),
    ([1] * 300 + [700], 301),
]


def _task_ids(case, seed):
    if case == "skew":
        return np.sort(_case(6000, 512, 1, seed=seed, skew=True)[1]), 512
    lengths, S = case
    return np.repeat(np.arange(S), lengths).astype(np.int32), S


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("case", TASK_CASES + ["skew"])
def test_task_table_covers_each_edge(case, tiled):
    """The kernel's pieces of work from the plain plan: the pieces of each
    segment tile its edge range exactly, in chunk order, each holds at most
    ``task_len`` edges, a segment of more than ``task_len`` edges is split
    into the pieces its tickets count (one a chunk it meets: (e1 - 1) // C
    - e0 // C + 1) and every other segment is one piece after the chunks',
    and the pieces over the plan's permutation sum to the plain version."""
    from graphgps_torch.ops.kernels import segment_sum as kseg

    sids, S = _task_ids(case, seed=3)
    ids = sids
    if tiled:
        ids = np.random.default_rng(4).permutation(sids).astype(np.int32)
    tids = torch.from_numpy(ids)
    plan = kseg.segment_plan(tids, S, tiled=tiled, task_len=C)
    seg, lo, hi = kseg.segment_tasks(plan)
    ptr = plan.ptr.numpy().astype(np.int64)
    assert (hi >= lo).all() and (hi - lo <= C).all()
    assert int((hi - lo).sum()) == len(ids)            # each edge once
    split = np.diff(ptr) > C
    whole = seg.shape[0] - int((~split).sum())
    assert (seg[whole:].numpy() == np.flatnonzero(~split)).all()
    for s in range(S):
        e0, e1 = ptr[s], ptr[s + 1]
        mine = (seg == s).nonzero()[:, 0].tolist()
        bounds = [(int(lo[t]), int(hi[t])) for t in mine]
        assert bounds[0][0] == e0 and bounds[-1][1] == e1
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        pieces = (e1 - 1) // C - e0 // C + 1 if split[s] else 1
        assert len(bounds) == pieces, (s, e0, e1)
    data = np.random.default_rng(5).standard_normal(
        (len(ids), 3)).astype(np.float32)
    rows = torch.from_numpy(data)
    if tiled:
        rows = rows[plan.perm.long()]
    edges = torch.cat([torch.arange(a, b) for a, b in zip(lo.tolist(),
                                                          hi.tolist())]
                      + [torch.zeros(0, dtype=torch.int64)])
    got = torch.zeros(S, 3).index_add_(
        0, seg.repeat_interleave(hi - lo), rows[edges])
    want = (kseg.tiled_segment_sum_plain(torch.from_numpy(data), tids, S)
            if tiled else kseg.segment_sum_csr_plain(
                torch.from_numpy(data), tids, plan.ptr, S))
    _close(got, want.numpy(), "sums over the tasks")
