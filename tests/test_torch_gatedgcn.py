"""The port's standalone GatedGCN core and drop-add, forward and backward,
on the CPU (their plain versions) against the JAX package's Pallas kernels
in interpret mode on the same numpy inputs: ``fused_gatedgcn`` at a lane
width, ``fused_gatedgcn_padded`` at d = 64 and d = 72 (the port runs at the
true width, the TPU kernel zero-pads to 128 lanes), with non-zero moment
shifts and random cotangents on all four outputs, moment partials included;
and ``fused_drop_add`` with JAX's ``_keep`` replaced by the port's hash.

Tolerance, f32: rtol = 1e-5 and atol = 1e-5 × max(1, max |reference|) per
tensor (the sums run in another order; a gradient entry is a sum of many
terms that cancel, so its rounding follows the terms' magnitude).

The last test runs on a CUDA device only: the four kernels against their
plain versions on the card."""
import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed
from test_torch_kernels import tail_parity_cases

torch.set_num_threads(2)

SEED = 12345

_NAMES = ("x", "e", "wn", "bn", "wc", "bc")
_REST = ("s_loc", "r_loc", "emask", "nmask", "cx", "cg")
_ORDER = ("x", "e", "s_loc", "r_loc", "emask", "nmask", "cx", "cg", "wn",
          "bn", "wc", "bc")


def ggcn_inputs(B=8, N=16, E=32, d=128, seed=0):
    """Blocked-layout inputs of the GatedGCN core, numpy. Graph 0 is a
    padded graph (no real node, no real edge: the partial-last-batch case);
    a padded edge points at node 0 of its own graph."""
    rng = np.random.default_rng(seed)
    nreal = rng.integers(2, N + 1, size=B)
    ereal = rng.integers(1, E + 1, size=B)
    nreal[0] = ereal[0] = 0
    s = np.zeros((B, E), np.int32)
    r = np.zeros((B, E), np.int32)
    em = np.zeros((B, E), np.float32)
    nm = np.zeros((B, N), np.float32)
    for g in range(B):
        nm[g, :nreal[g]] = 1.0
        k = ereal[g]
        s[g, :k] = rng.integers(0, nreal[g], size=k)
        r[g, :k] = rng.integers(0, nreal[g], size=k)
        em[g, :k] = 1.0
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    w = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)  # noqa
    return dict(x=f(B, N, d), e=f(B, E, d), s_loc=s, r_loc=r, emask=em,
                nmask=nm, cx=0.1 * f(d), cg=0.1 * f(d), wn=w(d, 4 * d),
                bn=0.1 * f(4 * d), wc=w(d, d), bc=0.1 * f(d))


def _args(a, diff, conv):
    m = dict(zip(_NAMES, diff), **{k: conv(a[k]) for k in _REST})
    return [m[k] for k in _ORDER]


def _cotangents(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cots(a, seed=7):
    B, N, d = a["x"].shape
    E = a["e"].shape[1]
    return _cotangents(np.random.default_rng(seed),
                       [(B, N, d), (B, E, d), (1, 2 * d), (1, 2 * d)])


@pytest.fixture
def port_masks(monkeypatch):
    """JAX's ``fused_tail._keep`` replaced by the port's dropout rule."""
    from graphgps_tpu.ops.pallas import fused_tail
    from tests.test_torch_grad import port_keep

    monkeypatch.setattr(fused_tail, "_keep", port_keep)
    return monkeypatch


def test_gatedgcn_fwd_bwd_match_jax(monkeypatch):
    """Two grid steps on the JAX side (GGPS_GGCN_G=4 of B=8)."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_gatedgcn import fused_gatedgcn as jg
    from graphgps_torch.ops.kernels import fused_gatedgcn
    from tests.test_torch_grad import _assert_close, _jax_vjp, _torch_vjp

    monkeypatch.setenv("GGPS_GGCN_G", "4")
    a = ggcn_inputs()
    diff = [a[k] for k in _NAMES]
    cots = _cots(a)
    want_out, want_grads = _jax_vjp(
        lambda *t: jg(*_args(a, t, jnp.asarray)), diff, cots)
    got_out, got_grads = _torch_vjp(
        lambda *t: fused_gatedgcn(*_args(a, t, torch.from_numpy)), diff, cots)
    _assert_close(got_out, want_out, ("xo", "gate", "px", "pg"))
    _assert_close(got_grads, want_grads, [f"d{n}" for n in _NAMES])
    # padded graph 0: its rows get exactly the gradient JAX gives them
    assert float(got_grads[0][0].abs().max()) == pytest.approx(
        float(np.abs(np.asarray(want_grads[0][0])).max()), abs=1e-5)


@pytest.mark.parametrize("d", [64, 72])
def test_gatedgcn_matches_jax_padded(d):
    """Widths that are no multiple of 128: JAX zero-pads every (d, d) block
    and slices the outputs; the port computes at d."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_gatedgcn import fused_gatedgcn_padded
    from graphgps_torch.ops.kernels import fused_gatedgcn
    from tests.test_torch_grad import _assert_close, _jax_vjp, _torch_vjp

    a = ggcn_inputs(B=4, N=8, E=16, d=d, seed=3)
    diff = [a[k] for k in _NAMES]
    cots = _cots(a, seed=9)

    def jfn(x, e, wn, bn, wc, bc):
        ws = [wn[:, i * d:(i + 1) * d] for i in range(4)]
        bs = [bn[i * d:(i + 1) * d] for i in range(4)]
        rest = [jnp.asarray(a[k]) for k in _REST]
        return fused_gatedgcn_padded(x, e, *rest, *ws, *bs, wc, bc)

    want_out, want_grads = _jax_vjp(jfn, diff, cots)
    got_out, got_grads = _torch_vjp(
        lambda *t: fused_gatedgcn(*_args(a, t, torch.from_numpy)), diff, cots)
    _assert_close(got_out, want_out, ("xo", "gate", "px", "pg"))
    _assert_close(got_grads, want_grads, [f"d{n}" for n in _NAMES])


def test_gatedgcn_backward_function_matches_autograd():
    """``gatedgcn_backward`` (what the CUDA autograd Function calls) equals
    autograd through the forward on the CPU, and cx/cg get no gradient."""
    from graphgps_torch.ops.kernels import fused_gatedgcn, gatedgcn_backward

    a = ggcn_inputs(B=2, N=8, E=8, d=64, seed=1)
    cots = [torch.from_numpy(c) for c in _cots(a, seed=2)]
    ins = [torch.from_numpy(a[k]) for k in _ORDER]
    for i in (0, 1, 6, 7, 8, 9, 10, 11):
        ins[i].requires_grad_()
    outs = fused_gatedgcn(*ins)
    want = torch.autograd.grad(outs, [ins[i] for i in (0, 1, 8, 9, 10, 11)],
                               cots, retain_graph=True)
    got = gatedgcn_backward(*(t.detach() for t in ins), *cots)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate,R,d", tail_parity_cases(
    [0.05, 0.5], (2048, 64), [0.05]))
def test_drop_add_fwd_bwd_match_jax(port_masks, rate, R, d):
    """R = 2048 rows of 64: two row blocks on the JAX side; and 3,080 x 64
    and 1,032 x 96 (5 and 3 row blocks); the kept fraction is the u8
    grid's."""
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_tail import fused_drop_add as jda
    from graphgps_torch.ops.kernels import drop_add_backward, fused_drop_add
    from tests.test_torch_grad import _assert_close, _jax_vjp, _torch_vjp

    rng = np.random.default_rng(4)
    diff = [rng.standard_normal((R, d)).astype(np.float32) for _ in range(2)]
    cots = _cotangents(rng, [(R, d)])
    want_out, want_grads = _jax_vjp(
        lambda *t: jda(*t, jnp.asarray(SEED, jnp.int32), rate), diff, cots)
    got_out, got_grads = _torch_vjp(
        lambda *t: fused_drop_add(*t, SEED, rate), diff, cots)
    _assert_close(got_out, [want_out], ["out"])
    _assert_close(got_grads, want_grads, ["dx_in", "dv"])
    dv = drop_add_backward(torch.from_numpy(cots[0]), SEED, rate)
    assert torch.equal(dv, got_grads[1])
    t = round(rate * 256)
    kept = float((dv != 0).float().mean())
    assert abs(kept - (1 - t / 256)) < 0.01

    port_masks.undo()
    default = jda(*map(jnp.asarray, diff), jnp.asarray(SEED, jnp.int32), rate)
    assert not np.allclose(np.asarray(default), np.asarray(want_out))


def test_drop_add_refuses_rate_zero():
    from graphgps_torch.ops.kernels import fused_drop_add

    t = torch.zeros(8, 4)
    for rate in (0.0, 1.0):
        with pytest.raises(ValueError, match="dropout rate"):
            fused_drop_add(t, t, 0, rate)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 40, 96, 64), (16, 24, 56, 304),
                                   (256, 40, 96, 256), (256, 40, 96, 304)])
def test_cuda_gatedgcn_drop_add_match_plain(cuda_device, shape):
    """On the card, at the molhiv layer shape, at a width that is no
    multiple of 64, at GPS-deep's layer with the front off (G') and at
    pcqm4m-GPS's (P): ``gatedgcn`` and ``drop_add`` forward and backward
    against their plain versions on the same tensors, one launch counted per
    call, two backward runs equal in every bit. f32; rtol = atol = 1e-4 for
    another summation order, a gradient's atol scaled by its tensor's
    largest entry; the (1, 2d) moment sums within 1e-5 of their largest
    entry.

    Runs on the card without JAX or this directory's conftest:
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_gatedgcn.py``."""
    from graphgps_torch.ops.kernels import (drop_add_backward,
                                            fused_drop_add, fused_gatedgcn,
                                            gatedgcn_backward)
    from graphgps_torch.ops.kernels.drop_add import drop_add_plain
    from graphgps_torch.ops.kernels.gatedgcn import gatedgcn_plain

    B, N, E, d = shape
    a = ggcn_inputs(B=B, N=N, E=E, d=d, seed=5)
    xs = [torch.from_numpy(a[k]).to(cuda_device) for k in _ORDER]
    diff = (0, 1, 8, 9, 10, 11)
    g = torch.Generator().manual_seed(3)

    def grads(fn, count):
        ins = [t.clone().requires_grad_() if i in diff else t
               for i, t in enumerate(xs)]
        outs = fn(*ins)
        cots = [torch.randn(o.shape, generator=torch.Generator()
                            .manual_seed(11 + j)).to(cuda_device)
                for j, o in enumerate(outs)]
        before = gatedgcn_backward.launches
        got = torch.autograd.grad(outs, [ins[i] for i in diff], cots)
        assert gatedgcn_backward.launches == before + count
        return outs, got

    before = fused_gatedgcn.launches
    outs, got = grads(fused_gatedgcn, 1)
    _, again = grads(fused_gatedgcn, 1)
    assert fused_gatedgcn.launches == before + 2
    wouts, want = grads(gatedgcn_plain, 0)
    for o, w in zip(outs[:2], wouts[:2]):
        torch.testing.assert_close(o, w, rtol=1e-4, atol=1e-4)
    for o, w in zip(outs[2:], wouts[2:]):
        torch.testing.assert_close(o, w, rtol=0.0,
                                   atol=1e-5 * float(w.abs().max()))
    for gt, ag, w in zip(got, again, want):
        assert torch.equal(gt, ag)
        torch.testing.assert_close(
            gt, w, rtol=1e-4, atol=1e-4 * max(1.0, float(w.abs().max())))

    R = B * N
    x, v, ct = (torch.randn(R, d, generator=g).to(cuda_device)
                for _ in range(3))
    seed = device_seed(77, cuda_device)
    for rate in (0.05, 0.5):
        v_ = v.clone().requires_grad_()
        before = (fused_drop_add.launches, drop_add_backward.launches)
        out = fused_drop_add(x, v_, seed, rate)
        dv, = torch.autograd.grad(out, v_, ct)
        assert (fused_drop_add.launches, drop_add_backward.launches) == \
            (before[0] + 1, before[1] + 1)
        vp = v.clone().requires_grad_()
        wout = drop_add_plain(x, vp, seed, rate)
        wdv, = torch.autograd.grad(wout, vp, ct)
        torch.testing.assert_close(out, wout, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dv, wdv, rtol=1e-6, atol=1e-6)
        assert torch.equal(dv, drop_add_backward(ct, seed, rate))
