"""The port's ``fused_ln_ffn`` (Graphormer's pre-LN FFN block) against the
JAX package's Pallas kernel ``fused_ln_ffn_padded`` in interpret mode, on the
CPU: the plain version, forward and backward, at d = 80 (the ZINC Graphormer
width, which the TPU kernel zero-pads to 128 lanes and normalises over the
true 80) and at d = 128 (no padding), with both dropout sites on at their own
rates and with both off. Then the wrapper's CPU rules, and on the card the
CUDA kernels against the plain version.

Dropout: JAX's ``fused_combine._keep`` is patched from here to the port's
counter hash over each site's true width (``keep_at`` of
``test_torch_unmerged.py``); a padded lane's index aliases a unit of the next
row, which is harmless since a padded lane carries zero. The patch counts its
calls, so a JAX path without the kernel fails the test.

Tolerance, f32: rtol 1e-5 and atol 1e-5 × the tensor's largest entry (the
sums run in another order; gelu's erf is exact here and a rational
approximation with |err| < 1.5e-7 inside the TPU kernel). The card's tests
run where there is no JAX: this file imports it inside its CPU tests only."""
import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
SEED = 4242


def ln_ffn_inputs(R, d, dh, seed=0):
    """(h0, ga, be, w1, b1, w2, b2, g) as float32 numpy; rows with an
    offset larger than their spread, as a residual stream has."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h0 = (f(R, d) + 3.0 * f(R, 1)).astype(np.float32)
    return (h0, (1.0 + 0.1 * f(d)).astype(np.float32), 0.1 * f(d),
            (f(d, dh) / np.sqrt(d)).astype(np.float32), 0.1 * f(dh),
            (f(dh, d) / np.sqrt(dh)).astype(np.float32), 0.1 * f(d), f(R, d))


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.mark.parametrize("d,r1,r2", [(80, 0.1, 0.2), (128, 0.1, 0.2),
                                     (80, 0.0, 0.0)])
def test_ln_ffn_plain_matches_jax(monkeypatch, d, r1, r2):
    """Output and the seven gradients (dh0, dγ, dβ, dW1, db1, dW2, db2)
    under a random cotangent, 256 rows, dh = d as in Graphormer."""
    import jax
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas import fused_combine
    from graphgps_torch.ops.kernels import ln_ffn
    from tests.test_torch_unmerged import keep_at

    keep = keep_at({1: d, 2: d})
    monkeypatch.setattr(fused_combine, "_keep", keep)
    *args, g = ln_ffn_inputs(256, d, d, seed=d)

    def jfn(*a):
        return fused_combine.fused_ln_ffn_padded(
            *a, jnp.asarray(SEED, jnp.int32), r1, r2, "gelu")

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    wgrads = vjp(jnp.asarray(g))
    assert keep.calls == (2 * ((r1 > 0) + (r2 > 0)))   # forward and backward

    targs = [torch.from_numpy(a) for a in args]
    before = ln_ffn.fused_ln_ffn.launches, ln_ffn.ln_ffn_backward.launches
    got = ln_ffn.fused_ln_ffn(*targs, SEED, r1, r2, "gelu")
    _close(got, want, "out")
    grads = ln_ffn.ln_ffn_backward(*targs, torch.from_numpy(g), SEED, r1, r2,
                                   "gelu")
    names = ("dh0", "dga", "dbe", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, grads, wgrads):
        assert a.shape == tuple(b.shape), name
        _close(a, b, name)
    # the CPU path is the plain version, and launches nothing
    assert (ln_ffn.fused_ln_ffn.launches,
            ln_ffn.ln_ffn_backward.launches) == before


def test_ln_ffn_wrapper_rules():
    """Rates outside [0, 1) and devices other than the CPU and CUDA are
    refused; autograd through the CPU path equals the plain backward."""
    from graphgps_torch.ops.kernels import ln_ffn

    args = [torch.from_numpy(a) for a in ln_ffn_inputs(16, 64, 64)]
    *ins, g = args
    for r1, r2 in ((1.0, 0.0), (0.0, -0.1)):
        with pytest.raises(ValueError, match="dropout"):
            ln_ffn.fused_ln_ffn(*ins, 0, r1, r2)
    with pytest.raises(ValueError, match="unsupported device"):
        ln_ffn.fused_ln_ffn(*(t.to("meta") for t in ins), 0, 0.1, 0.1)
    leaves = [t.clone().requires_grad_() for t in ins]
    out = ln_ffn.fused_ln_ffn(*leaves, 9, 0.3, 0.1)
    got = torch.autograd.grad(out, leaves, g)
    want = ln_ffn.ln_ffn_backward_plain(*ins, g, 9, 0.3, 0.1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("R,d,r1,r2", [(328, 80, 0.1, 0.2),
                                       (10496, 80, 0.1, 0.0),
                                       (1000, 96, 0.0, 0.0)])
def test_cuda_ln_ffn_matches_plain(cuda_device, R, d, r1, r2):
    """On the card: the forward kernel (alone, as evaluation runs it, and
    under autograd) and the backward kernel against the plain version and
    autograd through it on the same CUDA tensors; two backward runs equal in
    every bit, under autograd and as two calls of the backward kernel on
    the same kept tensors; one launch counted per call. rtol 1e-4, atol
    1e-5 × the tensor's largest entry (another summation order).

    Runs on the card without JAX or this directory's conftest:
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_ln_ffn.py``."""
    from graphgps_torch.ops.kernels import ln_ffn

    *ins, g = (torch.from_numpy(a).to(cuda_device)
               for a in ln_ffn_inputs(R, d, d, seed=R))
    conf = (device_seed(SEED, cuda_device), r1, r2, "gelu")
    fwd, bwd = ln_ffn.fused_ln_ffn, ln_ffn.ln_ffn_backward
    tol = lambda w: dict(rtol=1e-4,  # noqa: E731
                         atol=1e-5 * max(1.0, float(w.abs().max())))
    before = fwd.launches
    with torch.no_grad():
        out = fwd(*ins, *conf)
    assert fwd.launches == before + 1
    want = ln_ffn.ln_ffn_plain(*ins, *conf)
    torch.testing.assert_close(out, want, **tol(want))

    def grads():
        leaves = [t.clone().requires_grad_() for t in ins]
        return torch.autograd.grad(fwd(*leaves, *conf), leaves, g)

    before = fwd.launches, bwd.launches
    got, again = grads(), grads()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    want = ln_ffn.ln_ffn_backward_plain(*ins, g, *conf)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, **tol(w))

    _, kept = ln_ffn._launch_forward(tuple(ins), *conf, ln_ffn.EPS, True)
    before = bwd.launches
    first, second = (bwd(*ins, g, *conf, kept=kept) for _ in range(2))
    assert bwd.launches == before + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, **tol(w))
