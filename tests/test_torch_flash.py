"""The port's flash attention (``flash_mha``: segment-masked attention with
an optional additive bias) and the GPS layer's flash rung, against the JAX
package on the CPU.

JAX's ``flash_mha`` (``graphgps_tpu/ops/pallas/flash_mha.py:67``) calls the
TPU flash kernel of ``jax.experimental.pallas.ops.tpu.flash_attention``,
which has no CPU mode; the tests patch that module's ``flash_attention`` to
the library's own pure-jnp ``mha_reference_no_custom_vjp`` (the same
keywords; autodiff through it gives dq, dk, dv and the bias gradient) and
count its calls. The port's function runs its plain version (CPU tensors).
Forward and every gradient on every row, padded ones included, with and
without a bias, on ragged graphs and one with no real node. A small VOC
model with ``gt.attn_impl flash`` (256 node slots) against JAX's with
``flash_available`` patched true, in evaluation and in a training step at
attention dropout 0. JAX is imported inside the tests that use it, so the
card-only test runs on a machine without it.

Tolerance, f32: the function rtol = 1e-5, atol = 1e-5 × the tensor's
largest entry; the model rtol = atol = 1e-4 (PERF.md §2)."""
import numpy as np
import pytest
import torch

# by its file name: the card machine runs these tests without the conftest
from test_torch_wide import _hold_on_card, cuda_device  # noqa: F401

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
# two f64 evaluations of an attention output part by about 1e-16 of the sum
# of its terms' magnitudes; an entry that cancels to far below that sum is
# held to this much of it (the card test of the forward's rounding)
F64_CANCEL = 1e-14


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _inputs(B, H, N, Dh, seed=0, bias=True):
    """q, k, v, key_mask (graph 0 with no real node, the last one full, the
    others ragged prefixes) and a bias or None."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    counts = rng.integers(1, N + 1, (B,))
    counts[0], counts[-1] = 0, N
    mask = np.arange(N)[None, :] < counts[:, None]
    return (f(B, H, N, Dh), f(B, H, N, Dh), f(B, H, N, Dh), mask,
            f(B, H, N, N) if bias else None)


def _reference(monkeypatch):
    """Patch the library's TPU flash kernel to its pure-jnp reference;
    returns the counter of its calls."""
    from jax.experimental.pallas.ops.tpu import flash_attention as lib

    calls = {"n": 0}
    ref = lib.mha_reference_no_custom_vjp

    def flash_attention(*a, **k):
        calls["n"] += 1
        return ref(*a, **k)

    monkeypatch.setattr(lib, "flash_attention", flash_attention)
    return calls


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("B,H,N,Dh", [(2, 4, 256, 24), (3, 2, 128, 40)])
def test_flash_plain_matches_jax(monkeypatch, B, H, N, Dh, bias):
    """o on every row and the gradients of q, k, v (and the bias); the
    backward wrapper agrees with autograd through the function; padded rows
    attend over their graph's padded keys, real rows over its real ones."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import flash_mha as jflash
    from graphgps_torch.ops.kernels.flash_mha import (flash_mha,
                                                      flash_mha_backward)
    from graphgps_torch.ops.mha import mha

    calls = _reference(monkeypatch)
    q, k, v, mask, b = _inputs(B, H, N, Dh, 3, bias)
    go = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    ins = (q, k, v) + ((b,) if bias else ())
    want, vjp = jax.vjp(
        lambda *a: jflash.flash_mha(a[0], a[1], a[2], jnp.asarray(mask),
                                    a[3] if bias else None), *ins)
    want_g = vjp(jnp.asarray(go))
    assert calls["n"] == 1

    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    tmask = torch.from_numpy(mask)
    got = flash_mha(*tins[:3], tmask, tins[3] if bias else None)
    got_g = torch.autograd.grad(got, tins, torch.from_numpy(go))
    _close(got, want, "o")
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got_g, want_g):
        _close(a, w, name)
    again = flash_mha_backward(*(t.detach() for t in tins[:3]), tmask,
                               tins[3].detach() if bias else None,
                               got.detach(), torch.from_numpy(go))
    for a, w in zip(again, got_g):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    if not bias:
        # real rows: the dense rung's masked attention at scale 1/sqrt(Dh)
        dense = mha(*(torch.from_numpy(a) for a in (q, k, v)), tmask)
        real = tmask[:, None, :, None].expand_as(dense)
        torch.testing.assert_close(got.detach()[real], dense[real],
                                   rtol=1e-5, atol=1e-5)


def test_flash_dispatch_raises_jaxs_errors():
    """flash takes no attention dropout and no N below 256 or off the
    128-lane grid; at a size it takes it runs the flash function."""
    from graphgps_torch.ops.mha import flash_available, mha_dispatch

    assert flash_available(256) and flash_available(512)
    assert not flash_available(128) and not flash_available(264)
    q, k, v, mask, _ = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(2, 2, 256, 8, bias=False))
    with pytest.raises(ValueError, match="cannot apply attention dropout"):
        mha_dispatch(q, k, v, mask, 0, 0.5, impl="flash")
    small = [t[:, :, :128] for t in (q, k, v)]
    with pytest.raises(ValueError, match=r"needs lane-aligned N≥256 \(got "
                       r"N=128\)"):
        mha_dispatch(*small, mask[:, :128], impl="flash")
    from graphgps_torch.ops.kernels.flash_mha import flash_mha_plain

    torch.testing.assert_close(mha_dispatch(q, k, v, mask, impl="flash"),
                               flash_mha_plain(q, k, v, mask))


def test_flash_refuses_other_devices():
    from graphgps_torch.ops.kernels.flash_mha import flash_mha

    q, k, v, mask, b = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_mha(*(t.to("meta") for t in (q, k, v, mask, b)))


# the VOC stand-in at test size with 256 node slots: the flash rung's least N
FLASH_OPTS = ("dataset.max_nodes", "256", "gt.attn_impl", "flash",
              "gt.attn_dropout", "0.0")


def _flash_available(monkeypatch):
    from graphgps_tpu.ops.pallas import flash_mha as jflash

    monkeypatch.setattr(jflash, "flash_available",
                        lambda n, dh: n >= 256 and n % 128 == 0)


def test_voc_flash_model_eval_matches_jax(monkeypatch):
    """The recipe at 2 layers with ``gt.attn_impl flash`` in evaluation (the
    shipped attention dropout, which evaluation does not apply) on a full
    batch: logits for every real node; both packages took the flash rung in
    each layer."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax
    from tests.test_torch_voc import _jax_model, voc_loaders

    calls = _reference(monkeypatch)
    _flash_available(monkeypatch)
    jcfg, _, jl, tcfg, tsplits, tl = voc_loaders(*FLASH_OPTS[:4])
    assert tl["train"].max_nodes == 256 and tcfg.gt.attn_dropout == 0.5
    dim_out = infer_dims(tcfg, tsplits)
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    model = build_model(tcfg, dim_out).eval()
    load_flax(model, params, stats)
    calls["n"] = 0
    want, _ = jmodel.apply({"params": params, "batch_stats": stats}, jb,
                           False)
    assert calls["n"] == 2
    flash = FlashCalls(monkeypatch)
    with torch.no_grad():
        got, _ = model(tb)
    assert flash.calls == 2
    m = tb.node_mask.numpy()
    np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                               rtol=1e-4, atol=1e-4)


class FlashCalls:
    """Counts the mha dispatch's calls of ``flash_mha``."""

    def __init__(self, monkeypatch):
        from graphgps_torch.ops import kernels

        real = kernels.flash_mha
        self.calls = 0

        def counted(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(kernels, "flash_mha", counted)


def test_voc_auto_and_flash_predict_alike(monkeypatch):
    """One set of weights in evaluation: ``auto`` (the wide attention) and
    ``flash`` give the same logits on every real node of a full and of a
    partial batch (the partial one holds graphs with no real node)."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from tests.test_torch_voc import voc_loaders

    _, _, _, tcfg, tsplits, tl = voc_loaders(*FLASH_OPTS[:2])
    torch.manual_seed(0)
    model = build_model(tcfg, infer_dims(tcfg, tsplits)).eval()
    flash = FlashCalls(monkeypatch)
    for split in ("train", "val"):
        _, tb = next(iter(tl[split]))
        outs = []
        for impl in ("auto", "flash"):
            for layer in model.layers:
                layer.attn_impl = impl
            with torch.no_grad():
                outs.append(model(tb)[0])
        m = tb.node_mask
        torch.testing.assert_close(outs[1][m], outs[0][m], rtol=1e-4,
                                   atol=1e-5)
    assert flash.calls == 4


def test_voc_flash_train_step_matches_jax(monkeypatch):
    """One whole train step of the recipe at 2 layers with ``gt.attn_impl
    flash`` and attention dropout 0 (the same LapPE signs, weighted
    cross-entropy over the real nodes, adamW, clipping): loss, clipped
    gradients by the port's parameter names, updated running statistics."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.optim.optimizers import make_tx
    from graphgps_tpu.train.loop import TrainState, _build_raw_steps, run_key
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer
    from graphgps_torch.train.loop import train_step
    from graphgps_torch.weights import load_flax, state_dict_from_flax
    from tests.test_torch_train import _clip
    from tests.test_torch_voc import _jax_model, _patch_signs, voc_loaders

    calls = _reference(monkeypatch)
    _flash_available(monkeypatch)
    signs = _patch_signs(monkeypatch)
    jcfg, _, jl, tcfg, tsplits, tl = voc_loaders(
        *FLASH_OPTS, "optim.base_lr", "1e-3", "optim.scheduler", "none")
    dim_out = infer_dims(tcfg, tsplits)
    _, jb = next(iter(jl["train"]))
    _, tb = next(iter(tl["train"]))
    jmodel, (params, stats) = _jax_model(jcfg, dim_out, jb)
    tx = make_tx(jcfg)
    raw = _build_raw_steps(jcfg, jmodel, tx)
    jgrad = jax.jit(jax.value_and_grad(raw["forward"], has_aux=True))
    jstep = jax.jit(raw["train"])
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(params), step=jnp.asarray(0))
    rng = run_key(jcfg, 1)
    calls["n"] = 0
    (jloss, _), jg = jgrad(state.params, state.batch_stats, jb, rng,
                           jnp.asarray(0))
    state, *_ = jstep(state, jb, rng)
    assert calls["n"] > 0 and signs["jax"] > 0

    model = build_model(tcfg, dim_out).train()
    load_flax(model, params, stats)
    opt = build_optimizer(tcfg, model.parameters())
    flash = FlashCalls(monkeypatch)
    loss, *_ = train_step(tcfg, model, opt, tb,
                          torch.Generator().manual_seed(0))
    assert flash.calls == 2 and signs["torch"] == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4, err_msg="loss")
    named = dict(model.named_parameters())
    want_g = _clip({k: v.numpy() for k, v in
                    state_dict_from_flax(jax.device_get(jg)).items()})
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        np.testing.assert_allclose(
            named[k].grad.numpy(), g, rtol=1e-4,
            atol=1e-4 * max(1e-3, np.abs(g).max()), err_msg=f"grad {k}")
    new = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats)).items()}
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,Dh", [(4, 4, 512, 24), (2, 2, 384, 64),
                                      (1, 2, 200, 100), (3, 2, 136, 20),
                                      (2, 4, 520, 24), (2, 2, 520, 36),
                                      (2, 2, 136, 64), (1, 2, 200, 128)])
def test_cuda_flash_matches_plain(cuda_device, B, H, N, Dh):  # noqa: F811
    """On the card: the kernel through autograd against its plain version
    on the same CUDA tensors (ragged graphs, one with no real node, a ragged
    last tile: N no multiple of the 64-row tiles; heads of 20 to 128
    columns, multiples of 8 or not), with and without a bias: outputs and
    gradients close, two backward runs equal in every bit, one launch of
    each wrapper per call.
    Run it from the repository root: ``python -m pytest --noconftest -o
    addopts="" -p no:cacheprovider -m cuda tests/test_torch_flash.py``."""
    from graphgps_torch.ops.kernels.flash_mha import (flash_mha,
                                                      flash_mha_backward,
                                                      flash_mha_plain)

    q, k, v, mask, b = (torch.from_numpy(a).to(cuda_device)
                        for a in _inputs(B, H, N, Dh, 2))
    wrappers = (flash_mha, flash_mha_backward)
    _hold_on_card(lambda *a: flash_mha(*a, mask),
                  lambda *a: flash_mha_plain(*a, mask), [q, k, v], wrappers)
    _hold_on_card(lambda q_, k_, v_, b_: flash_mha(q_, k_, v_, mask, b_),
                  lambda q_, k_, v_, b_: flash_mha_plain(q_, k_, v_, mask, b_),
                  [q, k, v, b], wrappers)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,Dh,bias", [
    (32, 4, 512, 24, False), (32, 4, 512, 24, True), (1, 4, 5248, 24, False),
    (16, 4, 512, 20, False), (2, 4, 520, 24, True), (2, 4, 520, 20, False),
    (2, 2, 384, 64, True), (2, 2, 384, 64, False), (1, 2, 200, 128, True),
    (1, 2, 200, 128, False)])
def test_cuda_flash_forward_correctly_rounded(cuda_device, B, H, N, Dh,
                                              bias):  # noqa: F811
    """On the card: the forward computes in f64 and rounds once, so every
    output entry lies within 1 f32 ulp of the plain version evaluated in
    f64 on the same inputs and rounded to f32 (VOC-like 32 x 512 slots and
    wn-squirrel-like one graph of 5,248, heads of 20 to 128 columns, N = 520
    no multiple of the tiles, with and without a bias; ragged graphs, one
    with no real node), but where the entry cancels: two f64 evaluations of
    o = sum_j w_j v_j part by f64 rounding of the terms' magnitudes, so an
    entry further off lies within F64_CANCEL of sum_j w_j |v_j| from the
    f64 value (at B 2, N 520, heads of 20 one entry is 4.4e-11 of a 0.74
    sum, and the two f64 values lie 16 f32 ulps apart there). Two runs give
    the same bits.
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_flash.py``."""
    from graphgps_torch.ops.kernels.flash_mha import (f32_ulps, flash_mha,
                                                      flash_mha_plain)

    q, k, v, mask, b = (None if a is None
                        else torch.from_numpy(a).to(cuda_device)
                        for a in _inputs(B, H, N, Dh, 5, bias))
    with torch.no_grad():
        o = flash_mha(q, k, v, mask, b)
        again = flash_mha(q, k, v, mask, b)
        wide = [q.double(), k.double(), v.double(), mask,
                None if b is None else b.double()]
        want = flash_mha_plain(*wide)
        wide[2] = wide[2].abs()
        magnitude = flash_mha_plain(*wide)
    assert torch.equal(o, again)
    far = f32_ulps(o, want.float()) > 1
    assert bool(((o.double() - want).abs()[far]
                 <= F64_CANCEL * magnitude[far]).all())
