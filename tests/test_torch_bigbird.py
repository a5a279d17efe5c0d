"""The port's BigBird (``graphgps_torch/ops/bigbird.py``: the block plan and
the dispatch; ``graphgps_torch/ops/kernels/bigbird.py``: the block-sparse
attention kernel's wrapper and plain version) and the GPS layer's BigBird
global branch, against the JAX package on the CPU.

JAX's ``splash_bigbird`` (``graphgps_tpu/ops/pallas/splash_bigbird.py:87``)
runs the library's splash-attention kernel, which has an interpret mode:
the tests build it as ``_make_kernel`` does with ``interpret=True`` and
hold the port's function against it on every row, padded ones included,
forward and q/k/v gradients. The plans equal JAX's over a grid of sizes.
The GCN+BigBird layer (``block_sparse`` and ``original_full``) in
evaluation and in training with attention dropout (both on the dense path
off the card; JAX's attention and kernel draws patched to the port's masks,
as ``tests/test_torch_gcn.py`` does), and on the block-sparse path with
the dispatch of both packages forced at 256 node slots; CustomGatedGCN +
BigBird on the unmerged path; a 3-layer GCN+BigBird model's train step on
the transductive stand-in. The ``cuda`` cases hold the kernels against the
plain version on the card. JAX is imported inside the tests that use it,
so the card-only tests run on a machine without it.

Tolerance, f32: the function rtol 1e-5, atol 1e-5 × the tensor's largest
entry; layers and models rtol = atol 1e-4 (PERF.md §2)."""
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


# (n, block size, random blocks, seeds): JAX's plan is a Python loop over
# the (nb, nb) blocks, so its largest sizes take the larger blocks
PLAN_GRID = [(7, 1, 3, (0, 1, 2)), (7, 3, 0, (0,)), (100, 1, 2, (0, 2)),
             (256, 3, 3, (0, 1, 2)), (300, 64, 3, (0, 1)),
             (1000, 16, 1, (2,)), (2048, 3, 3, (0,)), (5248, 3, 3, (1,)),
             (5248, 64, 0, (0,))]


@pytest.mark.parametrize("n,bs,r,seeds", PLAN_GRID)
def test_block_plan_matches_jax(n, bs, r, seeds):
    """The plan (global rows and columns, the window, the seeded random
    blocks) and its dense expansion equal JAX's exactly."""
    from graphgps_tpu.ops import bigbird as jbb
    from graphgps_torch.ops import bigbird

    for seed in seeds:
        got = bigbird.block_plan(n, bs, r, seed)
        np.testing.assert_array_equal(got, jbb._block_plan(n, bs, r, seed))
        assert not got.flags.writeable
    if n <= 1000:
        np.testing.assert_array_equal(
            bigbird.bigbird_block_mask(n, bs, r, seeds[0]),
            jbb.bigbird_block_mask(n, bs, r, seeds[0]))


def _covered(side, n: int, bs: int):
    """The (own node, other node) pairs an item side's tasks name, counted:
    (n, n) int array."""
    pairs = np.zeros((n, n), np.int64)
    for i in range(len(side.item_row) - 1):
        rows = side.row[side.item_row[i]:side.item_row[i + 1]]
        for blk, lo, hi, _part, _first in side.task[
                side.item_task[i]:side.item_task[i + 1]]:
            pairs[blk * bs:(blk + 1) * bs, rows[side.slot[lo:hi]]] += 1
    return pairs


def _check_side(side, m, bs: int, rows: int):
    """One side's items against its pairs ``m``: every allowed pair once and
    no other, staged rows ascending and within ``rows``, entries within
    their item, chunk tasks of at most TASK_LEN with one partial slot each
    in order, and one first task a block."""
    from graphgps_torch.ops.kernels import bigbird as kb

    n = m.shape[0]
    np.testing.assert_array_equal(_covered(side, n, bs), m.astype(np.int64))
    sizes = np.diff(side.item_row)
    assert (sizes > 0).all() and sizes.max() == side.rows <= rows
    entries = [side.task[side.item_task[i]:side.item_task[i + 1], 1:3]
               for i in range(len(sizes))]
    assert max(int((e[:, 1] - e[:, 0]).sum()) for e in entries) \
        == side.entries
    for i in range(len(sizes)):
        staged = side.row[side.item_row[i]:side.item_row[i + 1]]
        assert (np.diff(staged) > 0).all()
        tasks = side.task[side.item_task[i]:side.item_task[i + 1]]
        assert 1 <= len(tasks) <= kb.run_blocks(bs)
        for _blk, lo, hi, _part, _first in tasks:
            assert 0 < hi - lo and (side.slot[lo:hi] < sizes[i]).all()
    firsts = np.zeros(-(-n // bs), np.int64)
    np.add.at(firsts, side.task[:, 0], side.task[:, 4])
    assert (firsts == 1).all()
    for blk, p0, n_c in side.comb:
        sel = side.task[side.task[:, 0] == blk]
        assert list(np.unique(sel[:, 3])) == list(range(p0, p0 + n_c))
        assert (np.diff(sel[:, 3]) >= 0).all()
        assert (sel[:, 2] - sel[:, 1] <= kb.TASK_LEN).all()
    for i in range(len(sizes)):   # a chunk's tasks share its slot
        parts = side.task[side.item_task[i]:side.item_task[i + 1], 3]
        assert len(set(parts.tolist())) == 1
    split = set(side.comb[:, 0].tolist())
    assert ((side.task[:, 3] < 0) == [b not in split
                                      for b in side.task[:, 0]]).all()
    assert side.parts == side.comb[:, 2].sum()


def test_plan_tables_cover_the_plan():
    """The kernels' item tables hold exactly the plan's pairs on both
    sides, each once, and cut the global blocks' lists (longer than an item
    stages) into chunks of tasks of at most TASK_LEN entries, one partial
    slot a chunk, in order."""
    from graphgps_torch.ops.bigbird import bigbird_block_mask
    from graphgps_torch.ops.kernels import bigbird as kb

    n, bs = 517, 3
    dense = bigbird_block_mask(n, bs, 3, 1)
    tables = kb.plan_tables(n, bs, 3, 1)
    for side, m in (("q", dense), ("k", dense.T)):
        _check_side(tables[side], m, bs, kb.MAX_ROWS)
        assert tables[side].parts > 0


@pytest.mark.parametrize("n,bs,r,seed,dh", [
    (5248, 3, 3, 0, 24), (2048, 3, 3, 1, 24), (517, 3, 3, 2, 24),
    (200, 1, 0, 0, 100), (384, 16, 1, 2, 64), (100, 7, 2, 1, 128),
    (301, 64, 3, 0, 24), (64, 3, 3, 0, 24), (5, 3, 1, 0, 24)])
def test_item_tables_cover_each_allowed_pair_once(n, bs, r, seed, dh):
    """The per-run item tables at several sizes (N off the block grid, a
    padded tail block, heads whose rows cap the staged rows, one or two
    blocks in all): every pair the plan allows on each side named by
    exactly one task, none off the plan, within the rows an item may stage
    at that head width."""
    from graphgps_torch.ops.bigbird import bigbird_block_mask
    from graphgps_torch.ops.kernels import bigbird as kb

    dense = bigbird_block_mask(n, bs, r, seed)
    rows = kb.max_rows(dh)
    tables = kb.plan_tables(n, bs, r, seed, rows)
    for side, m in (("q", dense), ("k", dense.T)):
        _check_side(tables[side], m, bs, rows)


def _inputs(B, H, N, Dh, seed=0):
    """q, k, v and a prefix key mask (the last graph full, the others
    ragged)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype(np.float32)
               for _ in range(3))
    counts = rng.integers(N // 2, N, B)
    counts[-1] = N
    mask = np.arange(N)[None, :] < counts[:, None]
    return q, k, v, mask


def _interpret_splash(monkeypatch):
    """JAX's ``_make_kernel`` built with the library's interpret mode;
    returns the counter of its builds."""
    from graphgps_tpu.ops.pallas import splash_bigbird as jsb
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk, splash_attention_mask as sm)

    calls = {"n": 0}

    def make(n, num_heads, block_size, num_random_blocks, seed):
        calls["n"] += 1
        m = jsb._lazy_bigbird_mask(n, block_size, num_random_blocks, seed)
        return sk.make_splash_mha(sm.MultiHeadMask([m] * num_heads),
                                  head_shards=1, q_seq_shards=1,
                                  interpret=True)

    monkeypatch.setattr(jsb, "_make_kernel", make)
    return calls


@pytest.mark.parametrize("bs,r,seed", [(3, 3, 1), (16, 1, 0)])
def test_bigbird_plain_matches_splash(monkeypatch, bs, r, seed):
    """The port's function against JAX's splash kernel (interpret mode) at
    B 2, H 2, N 256, Dh 24: o on every row, padded ones included, and the
    gradients of q, k and v; the backward wrapper agrees with autograd;
    real rows equal JAX's dense path."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import splash_bigbird as jsb
    from graphgps_torch.ops.bigbird import dense_bigbird
    from graphgps_torch.ops.kernels.bigbird import (bigbird_backward,
                                                    bigbird_block_sparse)

    calls = _interpret_splash(monkeypatch)
    q, k, v, mask = _inputs(2, 2, 256, 24, seed=bs)
    go = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    jmask = jnp.asarray(mask)
    want, vjp = jax.vjp(lambda a, b, c: jsb.splash_bigbird(
        a, b, c, jmask, bs, r, seed), q, k, v)
    want_g = vjp(jnp.asarray(go))
    assert calls["n"] == 1

    tins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tmask = torch.from_numpy(mask)
    got = bigbird_block_sparse(*tins, tmask, bs, r, seed)
    got_g = torch.autograd.grad(got, tins, torch.from_numpy(go))
    _close(got, want, "o")
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        _close(a, w, name)
    again = bigbird_backward(*(t.detach() for t in tins), tmask, bs, r, seed,
                             got.detach(), torch.from_numpy(go))
    for a, w in zip(again, got_g):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    dense = dense_bigbird(*(torch.from_numpy(a) for a in (q, k, v)), tmask,
                          bs, r, seed)
    real = tmask[:, None, :, None].expand_as(dense)
    torch.testing.assert_close(got.detach()[real], dense[real], rtol=1e-5,
                               atol=1e-5)


def test_splash_dispatch_rule(monkeypatch):
    """The block-sparse kernel on the card from SPLASH_MIN_N node slots on
    the 128 grid, without attention dropout; the dense path otherwise (the
    CPU's, with dropout, below the size or off the grid)."""
    from graphgps_torch.ops import bigbird

    cuda = torch.device("cuda", 0)
    assert bigbird.SPLASH_MIN_N == 2048
    assert bigbird.splash_available(2048, cuda)
    assert bigbird.splash_available(5248, cuda)
    assert not bigbird.splash_available(5248, "cpu")
    assert not bigbird.splash_available(1920, cuda)
    assert not bigbird.splash_available(2100, cuda)
    calls = []
    from graphgps_torch.ops import kernels

    monkeypatch.setattr(kernels, "bigbird_block_sparse",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(bigbird, "splash_available", lambda n, dev: True)
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 2, 256, 8))
    bigbird.bigbird_attention(q, k, v, mask, 3, 3, 0)
    assert len(calls) == 1 and calls[0][4:] == (3, 3, 0)
    bigbird.bigbird_attention(q, k, v, mask, 3, 3, 0, rate=0.5, drop_seed=1)
    assert len(calls) == 1


def test_bigbird_refuses_other_devices():
    from graphgps_torch.ops.kernels.bigbird import bigbird_block_sparse

    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 1, 16, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        bigbird_block_sparse(*(t.to("meta") for t in (q, k, v, mask)), 3, 1, 0)


# ---------------------------------------------------------------------------
# the layer

def _jax_layer(d, global_type="BigBird", local="GCN", attention_type=
               "block_sparse", dropout=0.0, attn_dropout=0.0, layer_index=2,
               batch_norm=False):
    from graphgps_tpu.models.gps_layer import GPSLayer as JaxGPSLayer

    return JaxGPSLayer(dim_h=d, local_gnn_type=local,
                       global_model_type=global_type, num_heads=4,
                       batch_norm=batch_norm, act="gelu", dropout=dropout,
                       attn_dropout=attn_dropout, layer_index=layer_index,
                       bigbird_attention_type=attention_type,
                       bigbird_block_size=3, bigbird_num_random_blocks=2)


def _layer_step(monkeypatch, jl, layer, batch, x, e, train, patches=None):
    """Output, and in training the gradients of x and every parameter under
    a random cotangent, of the JAX layer ``jl`` and the port's ``layer`` from
    the same weights; compared within rtol = atol 1e-4."""
    import jax
    import jax.numpy as jnp
    from tests.test_torch_layer import randomize_norms, torch_batch
    from graphgps_torch.weights import gps_layer_state_dict, to_torch

    var = jl.init(jax.random.PRNGKey(3), batch, x, e, False)
    params, stats = randomize_norms(var["params"],
                                    var.get("batch_stats", {}), seed=4)
    if patches is not None:
        patches.bits_calls = 0
    rng = np.random.default_rng(11)
    outs = (x,) if e is None else (x, e)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in outs]

    def f(p, x):
        out, _ = jl.apply({"params": p, "batch_stats": stats}, batch, x, e,
                          train, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return out[:len(outs)]

    jouts, vjp = jax.vjp(f, params, x)
    jgp, jgx = vjp(tuple(jnp.asarray(c) for c in cots))
    layer.train(train)
    layer.load_state_dict(to_torch(gps_layer_state_dict(params, stats)))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    te = None if e is None else torch.from_numpy(np.array(e))
    touts = layer(torch_batch(batch), tx, te,
                  torch.Generator().manual_seed(0))[:len(outs)]
    tol = dict(rtol=1e-4, atol=1e-4)
    for name, a, b in zip("xe", touts, jouts):
        _close(a, b, name, **tol)
    if not train:
        return
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(touts, [tx, *layer.parameters()],
                                [torch.from_numpy(c) for c in cots])
    _close(grads[0], jgx, "dx", **tol)
    want_g = gps_layer_state_dict(jax.device_get(jgp), None)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads[1:]):
        _close(g, want_g[name], f"d{name}", **tol)


@pytest.mark.parametrize("attention_type", ["block_sparse", "original_full"])
@pytest.mark.parametrize("train", [False, True])
def test_gcn_bigbird_layer_matches_jax(monkeypatch, attention_type, train):
    """One GCN+BigBird layer on 3 graphs of up to 120 node slots, both
    packages on the dense path (the CPU's): in evaluation the output; in
    training (dropout 0.2 through the drop-add and FFN kernels' plain
    versions, attention dropout 0.5 on the probabilities) also every
    gradient."""
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_gcn import ATTN_DROP, DROP, Patches
    from graphgps_torch.models.gps_layer import GPSLayer

    patches = Patches(monkeypatch, 96)
    batch, x, *_ = _blocked_batch(3, 120, 256, 96, seed=6)
    jl = _jax_layer(96, attention_type=attention_type, dropout=DROP,
                    attn_dropout=ATTN_DROP)
    layer = GPSLayer(96, 4, act="gelu", dropout=DROP, attn_dropout=ATTN_DROP,
                     local="GCN", batch_norm=False, global_type="BigBird",
                     bigbird=dict(attention_type=attention_type,
                                  block_size=3, num_random_blocks=2),
                     layer_index=2)
    _layer_step(monkeypatch, jl, layer, batch, x, None, train, patches)
    if train:
        assert patches.bits_calls == 3 and patches.attn_calls >= 1


def _force_block_sparse(monkeypatch):
    """Both packages' BigBird dispatch on the block-sparse path at any size
    on the 128 grid: JAX's splash in interpret mode, the port's kernel
    function (its plain version on CPU tensors), each call counted."""
    from graphgps_tpu.ops.pallas import splash_bigbird as jsb
    from graphgps_torch.ops import bigbird, kernels

    jcalls = _interpret_splash(monkeypatch)
    monkeypatch.setattr(jsb, "splash_available", lambda n: n % 128 == 0)
    monkeypatch.setattr(bigbird, "splash_available",
                        lambda n, dev: n % 128 == 0)
    tcalls = {"n": 0}
    real = kernels.bigbird_block_sparse

    def counted(*a):
        tcalls["n"] += 1
        return real(*a)

    monkeypatch.setattr(kernels, "bigbird_block_sparse", counted)
    return jcalls, tcalls


@pytest.mark.parametrize("train", [False, True])
def test_gcn_bigbird_layer_block_sparse_matches_jax(monkeypatch, train):
    """The layer on the block-sparse path of both packages (2 graphs of 256
    node slots, dispatch forced; training without attention dropout, as the
    kernel takes none): output and gradients, with one call of each
    package's block-sparse function."""
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_gcn import DROP, Patches
    from graphgps_torch.models.gps_layer import GPSLayer

    patches = Patches(monkeypatch, 96)
    jcalls, tcalls = _force_block_sparse(monkeypatch)
    batch, x, *_ = _blocked_batch(2, 256, 512, 96, seed=7)
    jl = _jax_layer(96, dropout=DROP)
    layer = GPSLayer(96, 4, act="gelu", dropout=DROP, local="GCN",
                     batch_norm=False, global_type="BigBird",
                     bigbird=dict(block_size=3, num_random_blocks=2),
                     layer_index=2)
    _layer_step(monkeypatch, jl, layer, batch, x, None, train, patches)
    assert jcalls["n"] >= 1 and tcalls["n"] == 1


@pytest.mark.parametrize("train", [False, True])
def test_gatedgcn_bigbird_layer_matches_jax(monkeypatch, train):
    """CustomGatedGCN+BigBird at d = 64: the unmerged path (the merged
    front runs Transformer attention only, as JAX's) with the BigBird
    branch, in evaluation and in training with dropout and attention
    dropout (JAX's draws patched as ``tests/test_torch_unmerged.py``
    does)."""
    from tests.test_fused_gatedgcn import _blocked_batch
    from tests.test_torch_unmerged import ATTN_DROP, DROP, Patches
    from graphgps_torch.models.gps_layer import GPSLayer

    patches = Patches(monkeypatch, 64)
    batch, x, e, *_ = _blocked_batch(8, 16, 32, 64, seed=5)
    jl = _jax_layer(64, local="CustomGatedGCN", dropout=DROP,
                    attn_dropout=ATTN_DROP, batch_norm=True)
    layer = GPSLayer(64, 4, act="gelu", dropout=DROP, attn_dropout=ATTN_DROP,
                     global_type="BigBird",
                     bigbird=dict(block_size=3, num_random_blocks=2),
                     layer_index=2)
    _layer_step(monkeypatch, jl, layer, batch, x, e, train, patches)
    if train:
        assert patches.bits_calls == 3 and patches.attn_calls == 1


def test_bigbird_refusals():
    """What the layer refuses: another attention type, another global
    model."""
    from graphgps_torch.models.gps_layer import GPSLayer

    with pytest.raises(ValueError, match="unknown bigbird attention_type"):
        GPSLayer(96, 4, local="GCN", global_type="BigBird",
                 bigbird=dict(attention_type="sparse"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        GPSLayer(96, 4, local="GCN", global_type="Performer")


def test_squirrel_bigbird_train_step_matches_jax(monkeypatch):
    """One whole train step of wn-squirrel as GCN+BigBird at 3 layers on
    the 300-node stand-in (dropout 0.2 through the drop-add and FFN kernels'
    plain versions, attention dropout 0.5 on BigBird's dense path, the plans
    of seeds 0-2): loss and clipped gradients by the port's parameter names,
    the port at one graph slot and JAX at 32."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_gcn import (Patches, _jax_batch, _jax_model,
                                      squirrel_loaders)
    from tests.test_torch_train import _clip

    patches = Patches(monkeypatch, 96)
    jcfg, _, jl, tcfg, tsplits, tl = squirrel_loaders(
        "gt.layer_type", "GCN+BigBird", "optim.base_lr", "1e-3",
        "optim.scheduler", "none", small=["gt.layers", "3",
                                          "dataset.synth_num_graphs", "300"])
    dim_out = infer_dims(tcfg, tsplits)
    jb = _jax_batch(jl["train"])
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    patches.bits_calls = patches.attn_calls = 0
    (jloss, _), jg = jax.value_and_grad(raw["forward"], has_aux=True)(
        state.params, state.batch_stats, jb, run_key(jcfg, 1), jnp.asarray(0))
    assert patches.bits_calls == 9 and patches.attn_calls == 3

    model = build_model(tcfg, dim_out).train()
    assert [layer.layer_index for layer in model.layers] == [0, 1, 2]
    assert all(layer.global_type == "BigBird" for layer in model.layers)
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    loss, *_ = train_step(tcfg, model, opt, tb,
                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    named = dict(model.named_parameters())
    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), g, rtol=1e-4,
            atol=1e-4 * max(1e-3, np.abs(g).max()), err_msg=f"grad {k}")


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    """Decided inside the fixture, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,Dh,bs,r,seed", [
    (1, 4, 5248, 24, 3, 3, 0), (4, 4, 2048, 24, 3, 3, 1),
    (2, 2, 384, 64, 16, 1, 2), (3, 1, 200, 100, 1, 0, 0)])
def test_cuda_bigbird_matches_plain(cuda_device, B, H, N, Dh, bs, r, seed):
    """On the card: the kernels through autograd against the plain version
    on the same CUDA tensors (ragged graphs, heads of 24 to 100, blocks of
    1 to 16): outputs and gradients close, two backward runs equal in every
    bit, one launch of each wrapper per call. Run it from the repository
    root: ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider
    -m cuda tests/test_torch_bigbird.py``."""
    from graphgps_torch.ops.kernels import bigbird as kb

    q, k, v, mask = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(B, H, N, Dh, seed))
    fn = lambda q_, k_, v_: kb.bigbird_block_sparse(  # noqa: E731
        q_, k_, v_, mask, bs, r, seed)
    plain = lambda q_, k_, v_: kb.bigbird_plain(  # noqa: E731
        q_, k_, v_, mask, bs, r, seed)
    before = (kb.bigbird_block_sparse.launches, kb.bigbird_backward.launches)
    outs = []
    for f in (fn, fn, plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = f(*leaves)
        g = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
        outs.append((o, *torch.autograd.grad(o, leaves, g.to(o.device))))
    assert (kb.bigbird_block_sparse.launches - before[0],
            kb.bigbird_backward.launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    for a, b in zip(outs[0], outs[2]):
        torch.testing.assert_close(a, b, rtol=RTOL,
                                   atol=ATOL * float(b.abs().max()))
