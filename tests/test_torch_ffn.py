"""The port's ``fused_ffn`` (the GPS FFN block with its residual) against
the JAX package's Pallas kernel in interpret mode, on the CPU: the plain
version, forward and backward (the cotangents of h and of the four FFN
tensors), against ``fused_ffn`` itself at d = 64 and against
``fused_ffn_padded`` at d = 64 and at d = 96 (the wn-squirrel width, which
the TPU wrapper zero-pads to 128 lanes and its hidden 192 to 256), with
relu and gelu, at rate 0 and 0.2, with the outer dropout site on and off
(SAN's ``drop2=False``). 1,040 rows, so the JAX grid takes 2 to 5 row
blocks. Then the wrapper's CPU rules, and on the card the CUDA kernels
against the plain version.

Dropout: ``fused_tail._keep`` is patched from here to the port's counter
hash over each site's true width. The TPU kernel numbers its sites 0 (inner)
and 1 (outer); the port's kernel keys them as sites 1 and 2, as the other
FFN kernels do (``ffn_keep``). The patch counts its calls, so a JAX path
without the kernel fails the test.

Tolerance, f32: rtol 1e-5 and atol 1e-5 × the tensor's largest entry (the
sums run in another order; gelu's erf is exact in the port and a rational
approximation with |err| < 1.5e-7 in the TPU kernel). The card's tests run
where there is no JAX: this file imports it inside its CPU tests only."""
import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
SEED = 4242
ROWS = 1040
NAMES = ("dh", "dw1", "db1", "dw2", "db2")


def ffn_inputs(R, d, dh, seed=0):
    """(h, w1, b1, w2, b2, g) as float32 numpy: a residual stream and
    weights at Dense's scale."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(R, d), (f(d, dh) / np.sqrt(d)).astype(np.float32),
            0.1 * f(dh), (f(dh, d) / np.sqrt(dh)).astype(np.float32),
            0.1 * f(d), f(R, d))


def ffn_keep(widths, sites):
    """The port's dropout rule with the JAX ``_keep`` signature for a
    kernel whose site ``offset`` is the port's site ``sites[offset]`` of
    true width ``widths[offset]`` (its block may be zero-padded to more
    lanes; padded lanes carry zeros). ``widths``/``sites`` may also be
    callables of (offset, block shape)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tests.test_torch_grad import _mix32

    def pick(table, offset, shape):
        return table(offset, shape) if callable(table) else table[offset]

    def keep(seed_ref, offset, shape, rate):
        keep.calls += 1
        t = min(max(int(round(rate * 256)), 1), 255)
        u32 = jnp.uint32
        site = pick(sites, offset, shape)
        key = _mix32(seed_ref[0].astype(u32) + u32(0x9E3779B9) * u32(site + 1))
        row = (pl.program_id(0).astype(u32) * u32(shape[0])
               + jax.lax.broadcasted_iota(u32, shape, 0))
        idx = (row * u32(pick(widths, offset, shape))
               + jax.lax.broadcasted_iota(u32, shape, 1))
        bits = _mix32(idx ^ _mix32(key))
        return ((bits & u32(255)) >= u32(t)).astype(jnp.float32), \
            1.0 / (1.0 - t / 256.0)

    keep.calls = 0
    return keep


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.mark.parametrize("jfn_name,d", [("fused_ffn", 64),
                                        ("fused_ffn_padded", 64),
                                        ("fused_ffn_padded", 96)])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("rate,drop2", [(0.0, True), (0.2, True),
                                        (0.2, False)])
def test_ffn_plain_matches_jax(monkeypatch, jfn_name, d, act, rate, drop2):
    """Output and the five gradients under a random cotangent, dh = 2d as
    in the GPS layer."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import fused_tail
    from graphgps_torch.ops.kernels import ffn

    keep = ffn_keep({0: 2 * d, 1: d}, {0: 1, 1: 2})
    monkeypatch.setattr(fused_tail, "_keep", keep)
    *args, g = ffn_inputs(ROWS, d, 2 * d, seed=d + int(10 * rate) + drop2)

    def jfn(*a):
        return getattr(fused_tail, jfn_name)(
            *a, jnp.asarray(SEED, jnp.int32), rate, act, drop2=drop2)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    wgrads = vjp(jnp.asarray(g))
    # forward and backward, each site that is on
    assert keep.calls == 2 * ((rate > 0) + (rate > 0 and drop2))

    targs = [torch.from_numpy(a) for a in args]
    before = ffn.fused_ffn.launches, ffn.ffn_backward.launches
    got = ffn.fused_ffn(*targs, SEED, rate, act, drop2)
    _close(got, want, "out")
    grads = ffn.ffn_backward(*targs, torch.from_numpy(g), SEED, rate, act,
                             drop2)
    for name, a, b in zip(NAMES, grads, wgrads):
        assert a.shape == tuple(b.shape), name
        _close(a, b, name)
    # the CPU path is the plain version, and launches nothing
    assert (ffn.fused_ffn.launches, ffn.ffn_backward.launches) == before


def test_ffn_outer_site_is_its_own():
    """``drop2`` drops units of the second product's output on site 2 and
    leaves site 1's mask as it was: with drop2 the output differs from the
    drop2-free one exactly where site 2 drops or rescales."""
    from graphgps_torch.ops.kernels import ffn
    from graphgps_torch.ops.kernels.common import dropout_mask

    *args, _ = (torch.from_numpy(a) for a in ffn_inputs(64, 96, 192))
    off = ffn.ffn_plain(*args, 7, 0.2, "gelu", False)
    on = ffn.ffn_plain(*args, 7, 0.2, "gelu", True)
    h = args[0]
    m2 = dropout_mask(7, 2, 64, 96, 0.2)
    torch.testing.assert_close(on, h + (off - h) * m2, rtol=1e-6, atol=1e-6)


def test_ffn_wrapper_rules():
    """Rates outside [0, 1), unknown activations and devices other than the
    CPU and CUDA are refused; autograd through the CPU path equals the plain
    backward, and the plain backward with its own side of every relu kink
    as ``relu_mask`` is the same."""
    from graphgps_torch.ops.kernels import ffn

    *ins, g = (torch.from_numpy(a) for a in ffn_inputs(16, 64, 128))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            ffn.fused_ffn(*ins, 0, rate)
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.fused_ffn(*(t.to("meta") for t in ins), 0, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.ffn_backward(*(t.to("meta") for t in ins), g.to("meta"), 0, 0.1)
    with pytest.raises(ValueError, match="unsupported act"):
        ffn._check_conf("fused_ffn", 0.1, "tanh")
    leaves = [t.clone().requires_grad_() for t in ins]
    out = ffn.fused_ffn(*leaves, 9, 0.3, "relu", True)
    got = torch.autograd.grad(out, leaves, g)
    want = ffn.ffn_backward_plain(*ins, g, 9, 0.3, "relu", True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    mask = (ins[0] @ ins[1] + ins[2] > 0).float()
    again = ffn.ffn_backward_plain(*ins, g, 9, 0.3, "relu", True,
                                   relu_mask=mask)
    for a, b in zip(again, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,dh,fused,smem", [
    (96, 192, True, (175616, 196864)),    # wn-squirrel (Q)
    (64, 128, True, (84480, 99072)),      # actor (A), SAN's S
    (304, 608, False, None)])             # W: the tensor-core sequence
def test_ffn_route_rule(d, dh, fused, smem):
    """``ffn`` takes ``bn_ffn``'s route rule, one function both import:
    fused at wn-squirrel's and actor's widths, the launch sequence at d =
    304; the shared memory a fused block lays out each way is
    ``FfnLayout``'s (W1, W2 and the 16-row tiles, csrc/ffn_fused.cuh)."""
    from graphgps_torch.ops.kernels import bn_ffn, ffn, ffn_fused

    assert ffn.takes_fused is ffn_fused.takes_fused is bn_ffn.takes_fused
    assert ffn_fused.takes_fused(d, dh) is fused
    sizes = tuple(ffn_fused.fused_smem(d, dh, b) for b in (False, True))
    assert (max(sizes) <= ffn_fused.FUSED_SMEM_LIMIT) is fused
    if smem is not None:
        assert sizes == smem
        # FfnLayout's floats, from its strides: W1 [dp][ld], W2 [dhp][ld]
        # and the tiles of 16 rows
        assert sizes[0] == 4 * (d * (dh + 8) + dh * (d + 8)
                                + 16 * (d + 4 + dh + 4))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("R,d,rate,act,drop2", [
    (5248, 96, 0.2, "gelu", True), (5248, 96, 0.0, "gelu", True),
    (7680, 64, 0.2, "relu", True), (1000, 96, 0.2, "relu", False),
    (2000, 304, 0.2, "gelu", True), (37, 36, 0.2, "relu", True)])
def test_cuda_ffn_matches_plain(cuda_device, R, d, rate, act, drop2):
    """On the card, at wn-squirrel's (R = 5,248 node slots, d = 96) and
    actor's (R = 7,680, d = 64) shapes on the fused route, at d = 304 on
    the launch sequence, and at a ragged 37 rows of d = 36 (one tile
    short of its 16 rows, 4-byte staging): the forward kernel (alone, as
    evaluation would run it, and under autograd) and the backward kernel
    against the plain version and autograd through it on the same CUDA
    tensors (relu's derivative on the kernel's side of each kink,
    ``relu_mask``); two backward runs equal in every bit; one launch
    counted per call. rtol 1e-5, atol 1e-5 × the tensor's largest entry.

    Runs on the card without JAX or this directory's conftest:
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_ffn.py``."""
    from graphgps_torch.ops.kernels import ffn

    *ins, g = (torch.from_numpy(a).to(cuda_device)
               for a in ffn_inputs(R, d, 2 * d, seed=R))
    conf = (device_seed(SEED, cuda_device), rate, act, drop2)
    fwd, bwd = ffn.fused_ffn, ffn.ffn_backward
    tol = lambda w: dict(rtol=RTOL,  # noqa: E731
                         atol=ATOL * max(1.0, float(w.abs().max())))
    before = fwd.launches
    with torch.no_grad():
        out = fwd(*ins, *conf)
    assert fwd.launches == before + 1
    mask = None
    if act == "relu":
        # the kernel's side of each relu kink, from its own pre-activation;
        # a unit on the other side in the plain version lies within
        # rounding of 0
        with torch.no_grad():
            a1 = ffn._launch_forward(tuple(ins), *conf, keep_a1=True)[1]
            a1_plain = ins[0] @ ins[1] + ins[2]
        mask = (a1 > 0).float()
        flips = (a1_plain > 0).float() != mask
        far = float(a1_plain[flips].abs().max()) if flips.any() else 0.0
        assert far < 1e-5 * float(a1_plain.abs().max())
    want = ffn.ffn_plain(*ins, *conf, relu_mask=mask)
    torch.testing.assert_close(out, want, **tol(want))

    def grads():
        leaves = [t.clone().requires_grad_() for t in ins]
        return torch.autograd.grad(fwd(*leaves, *conf), leaves, g)

    before = fwd.launches, bwd.launches
    got, again = grads(), grads()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    want = ffn.ffn_backward_plain(*ins, g, *conf, relu_mask=mask)
    for name, a, b, w in zip(NAMES, got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, w, **tol(w), msg=name)


@pytest.mark.cuda
def test_cuda_ffn_route_rule_matches_source(cuda_device):
    """The wrapper's route rule is the C side's (``ffn_fused_fits``, the
    same ``fused::fits`` as ``bn_ffn``'s); the fused backward (its
    persistent layout, the warps' weight-gradient registers) takes every
    GPS width d = dh / 2 that the rule takes, and each fused block's shared
    memory fits the card's 227 KB."""
    import ctypes

    from graphgps_torch.ops.kernels import build, ffn_fused

    fits = build.cfunc("ffn", "ffn_fused_fits", [ctypes.c_int] * 2)
    back = build.cfunc("ffn", "ffn_fused_backward_fits", [ctypes.c_int] * 2)
    smem = build.cfunc("ffn", "ffn_fused_smem", [ctypes.c_int] * 3,
                       ctypes.c_longlong)
    for d, dh in ((64, 128), (96, 192), (104, 208), (36, 72), (80, 160),
                  (128, 96), (304, 608), (16, 2048)):
        fused = ffn_fused.takes_fused(d, dh)
        assert bool(fits(d, dh)) is fused
        if fused and dh == 2 * d:
            assert back(d, dh) == 1
        if fused:
            for way in (0, 1):
                assert smem(d, dh, way) <= ffn_fused.FUSED_SMEM_LIMIT
    assert smem(96, 192, 0) == 175616 + 4 * 16 * 100   # h double-buffered
