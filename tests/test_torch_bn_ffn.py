"""The port's ``fused_bn_ffn`` (SAN's attention-norm apply + FFN block)
against the JAX package's Pallas kernel ``fused_bn_ffn_padded`` in interpret
mode, on the CPU: the plain version, forward and backward (the cotangents
of s, the norm's mean and rsqrt(var + eps), its scale and bias, and the four
FFN tensors), at d = 64 (the ogbg-molhiv SAN width, which the TPU kernel
zero-pads to 128 lanes) and at d = 80 (a width off 128 whose hidden 160 is
padded too), at rate 0, at the recipe's 0.01 and at 0.2, with the outer
dropout site off (SAN's ``drop2=False``) and on. Then the wrapper's CPU
rules, and on the card the CUDA kernels against the plain version.

Dropout: JAX's ``fused_combine._keep`` is patched from here to the port's
counter hash over each site's true width (``keep_at`` of
``test_torch_unmerged.py``); the patch counts its calls, so a JAX path
without the kernel fails the test.

Tolerance, f32: rtol 1e-5 and atol 1e-5 × the tensor's largest entry (the
sums run in another order). The card's tests run where there is no JAX: this
file imports it inside its CPU tests only."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
SEED = 5151


def bn_ffn_inputs(R, d, dh, seed=0):
    """(s, mu, inv, ga, be, w1, b1, w2, b2, g) as float32 numpy: rows with
    an offset per column and the norm's statistics near theirs, as a
    residual stream before its BatchNorm has them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    off = 2.0 * f(d)
    s = (f(R, d) * (1.0 + 0.5 * np.abs(f(d))) + off).astype(np.float32)
    mu = (off + 0.1 * f(d)).astype(np.float32)
    inv = (1.0 / (1.0 + 0.5 * np.abs(f(d)))).astype(np.float32)
    return (s, mu, inv, (1.0 + 0.1 * f(d)).astype(np.float32), 0.1 * f(d),
            (f(d, dh) / np.sqrt(d)).astype(np.float32), 0.1 * f(dh),
            (f(dh, d) / np.sqrt(dh)).astype(np.float32), 0.1 * f(d), f(R, d))


NAMES = ("ds", "dmu", "dinv", "dga", "dbe", "dw1", "db1", "dw2", "db2")


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.mark.parametrize("d,rate,drop2,act", [
    (64, 0.01, False, "relu"), (64, 0.2, True, "relu"),
    (64, 0.0, False, "relu"), (80, 0.2, False, "relu"),
    (80, 0.01, True, "gelu")])
def test_bn_ffn_plain_matches_jax(monkeypatch, d, rate, drop2, act):
    """Output and the nine gradients under a random cotangent, 256 rows,
    dh = 2d as in SAN."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import fused_combine
    from graphgps_torch.ops.kernels import bn_ffn
    from tests.test_torch_unmerged import keep_at

    keep = keep_at({1: 2 * d, 2: d})
    monkeypatch.setattr(fused_combine, "_keep", keep)
    *args, g = bn_ffn_inputs(256, d, 2 * d, seed=d + int(100 * rate))

    def jfn(*a):
        return fused_combine.fused_bn_ffn_padded(
            *a, jnp.asarray(SEED, jnp.int32), rate, act, drop2=drop2)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    wgrads = vjp(jnp.asarray(g))
    # forward and backward, each site that is on
    assert keep.calls == 2 * ((rate > 0) + (rate > 0 and drop2))

    targs = [torch.from_numpy(a) for a in args]
    before = bn_ffn.fused_bn_ffn.launches, bn_ffn.bn_ffn_backward.launches
    got = bn_ffn.fused_bn_ffn(*targs, SEED, rate, act, drop2)
    _close(got, want, "out")
    grads = bn_ffn.bn_ffn_backward(*targs, torch.from_numpy(g), SEED, rate,
                                   act, drop2)
    for name, a, b in zip(NAMES, grads, wgrads):
        assert a.shape == tuple(b.shape), name
        _close(a, b, name)
    # the CPU path is the plain version, and launches nothing
    assert (bn_ffn.fused_bn_ffn.launches,
            bn_ffn.bn_ffn_backward.launches) == before


def test_bn_ffn_outer_site_is_its_own():
    """``drop2`` drops units of the second product's output on site 2 and
    leaves site 1's mask as it was: with drop2 the output differs from the
    drop2-free one exactly where site 2 drops or rescales."""
    from graphgps_torch.ops.kernels import bn_ffn
    from graphgps_torch.ops.kernels.common import dropout_mask

    *args, _ = (torch.from_numpy(a) for a in bn_ffn_inputs(64, 64, 128))
    off = bn_ffn.bn_ffn_plain(*args, 7, 0.2, "relu", False)
    on = bn_ffn.bn_ffn_plain(*args, 7, 0.2, "relu", True)
    s, mu, inv, ga, be = args[:5]
    h = (s - mu) * inv * ga + be
    m2 = dropout_mask(7, 2, 64, 64, 0.2)
    torch.testing.assert_close(on, h + (off - h) * m2, rtol=1e-6, atol=1e-6)


def test_bn_ffn_wrapper_rules():
    """Rates outside [0, 1), unknown activations and devices other than the
    CPU and CUDA are refused; autograd through the CPU path equals the plain
    backward."""
    from graphgps_torch.ops.kernels import bn_ffn

    *ins, g = (torch.from_numpy(a) for a in bn_ffn_inputs(16, 64, 128))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            bn_ffn.fused_bn_ffn(*ins, 0, rate)
    with pytest.raises(ValueError, match="unsupported device"):
        bn_ffn.fused_bn_ffn(*(t.to("meta") for t in ins), 0, 0.1)
    with pytest.raises(ValueError, match="unsupported act"):
        bn_ffn._check_conf("fused_bn_ffn", 0.1, "tanh")
    leaves = [t.clone().requires_grad_() for t in ins]
    out = bn_ffn.fused_bn_ffn(*leaves, 9, 0.3, "relu", True)
    got = torch.autograd.grad(out, leaves, g)
    want = bn_ffn.bn_ffn_backward_plain(*ins, g, 9, 0.3, "relu", True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the plain version's own side of every kink as relu_mask: the same
    s, mu, inv, ga, be, w1, b1 = ins[:7]
    mask = (((s - mu) * inv * ga + be) @ w1 + b1 > 0).float()
    again = bn_ffn.bn_ffn_backward_plain(*ins, g, 9, 0.3, "relu", True,
                                         relu_mask=mask)
    for a, b in zip(again, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,dh,fused", [
    (64, 128, True),      # ogbg-molhiv SAN: 84,480 B forward, 99,072 back
    (96, 192, True),      # the widest d = dh / 2 that fits (16-aligned)
    (104, 208, False),    # padded to 112 / 224: 267,008 B backward
    (112, 224, False), (304, 608, False),   # molpcba-SAN: the sequence
    (36, 72, True), (128, 96, True), (64, 768, False)])
def test_bn_ffn_width_rule(d, dh, fused):
    """The route by width at the fused limit's boundary: fused when both
    ways' blocks fit in the card's 227 KB, the tensor-core GEMM's sequence
    beyond (the card test holds the C side's rule to this one); the rule
    is ``ffn_fused``'s, which ``ffn`` shares."""
    from graphgps_torch.ops.kernels import bn_ffn, ffn_fused

    sizes = [ffn_fused.fused_smem(d, dh, b) for b in (False, True)]
    assert bn_ffn.takes_fused(d, dh) is fused
    assert (max(sizes) <= ffn_fused.FUSED_SMEM_LIMIT) is fused
    assert ffn_fused.FUSED_SMEM_LIMIT == 227 * 1024
    if (d, dh) == (64, 128):
        assert sizes == [84480, 99072]
    if (d, dh) == (104, 208):
        assert sizes[1] == 267008


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("R,d,rate,drop2", [(2560, 64, 0.01, False),
                                            (2560, 64, 0.0, False),
                                            (1000, 80, 0.2, True),
                                            (4104, 96, 0.1, True),
                                            (1000, 112, 0.1, False),
                                            (333, 36, 0.1, True),
                                            (20480, 304, 0.2, False)])
def test_cuda_bn_ffn_matches_plain(cuda_device, R, d, rate, drop2):
    """On the card: the forward kernel (alone, as evaluation would run it,
    and under autograd) and the backward kernel against the plain version
    and autograd through it on the same CUDA tensors (relu's derivative on
    the kernel's side of each kink, ``relu_mask``); two backward runs equal
    in every bit; one launch counted per call. rtol 1e-5, atol 1e-5 × the
    tensor's largest entry (another summation order). The fused route at
    SAN's width, at its limit (d = 96) and at widths off 4 (d = 36: 4-byte
    copies, padded fragments), the launch sequence just past the limit
    (d = 112) and at molpcba-SAN's width.

    Runs on the card without JAX or this directory's conftest:
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_bn_ffn.py``."""
    from graphgps_torch.ops.kernels import bn_ffn

    *ins, g = (torch.from_numpy(a).to(cuda_device)
               for a in bn_ffn_inputs(R, d, 2 * d, seed=R))
    conf = (SEED, rate, "relu", drop2)
    fwd, bwd = bn_ffn.fused_bn_ffn, bn_ffn.bn_ffn_backward
    tol = lambda w: dict(rtol=RTOL,  # noqa: E731
                         atol=ATOL * max(1.0, float(w.abs().max())))
    before = fwd.launches
    with torch.no_grad():
        out = fwd(*ins, *conf)
    assert fwd.launches == before + 1
    want = bn_ffn.bn_ffn_plain(*ins, *conf)
    torch.testing.assert_close(out, want, **tol(want))

    def grads():
        leaves = [t.clone().requires_grad_() for t in ins]
        return torch.autograd.grad(fwd(*leaves, *conf), leaves, g)

    before = fwd.launches, bwd.launches
    got, again = grads(), grads()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    # the kernel's side of each relu kink, from its own pre-activation; a
    # unit on the other side in the plain version lies within rounding of 0
    a1 = bn_ffn._launch_forward(tuple(ins), *conf, True)[1][1]
    mask = (a1 > 0).float()
    a1_plain = ((ins[0] - ins[1]) * ins[2] * ins[3] + ins[4]) @ ins[5] \
        + ins[6]
    flips = (a1_plain > 0).float() != mask
    far = float(a1_plain[flips].abs().max()) if flips.any() else 0.0
    assert far < 1e-5 * float(a1_plain.abs().max())
    want = bn_ffn.bn_ffn_backward_plain(*ins, g, *conf, relu_mask=mask)
    for name, a, b, w in zip(NAMES, got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, w, **tol(w), msg=name)


@pytest.mark.cuda
def test_cuda_fused_rule_matches_source(cuda_device):
    """The wrapper's width rule is the C side's: the shared memory a fused
    block takes each way and whether the route takes the widths."""
    import ctypes

    from graphgps_torch.ops.kernels import build, bn_ffn, ffn_fused

    smem = build.cfunc("bn_ffn", "bn_ffn_fused_smem", [ctypes.c_int] * 3,
                       ctypes.c_longlong)
    fits = build.cfunc("bn_ffn", "bn_ffn_fused_fits", [ctypes.c_int] * 2)
    for d, dh in ((64, 128), (96, 192), (104, 208), (36, 72), (80, 160),
                  (128, 96), (304, 608), (16, 2048)):
        for back in (False, True):
            assert smem(d, dh, int(back)) == ffn_fused.fused_smem(d, dh,
                                                                  back)
        assert bool(fits(d, dh)) is bn_ffn.takes_fused(d, dh)
