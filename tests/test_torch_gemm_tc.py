"""The port's tensor-core GEMM (``graphgps_torch/csrc/gemm_tc.cuh``: 3xTF32
``mma.sync``, the products of ``gps_front`` and ``gps_attention``) on its
own, on the card: NN, NT and the split TN against an f64 ``torch.matmul``
at the shapes those kernels meet at their edges (row counts off the tiles,
K = 304 (the pcqm4m-GPS width), N = 1,792 (the front's 7d) and 768), with
each piece of the epilogue (bias, the stored pre-activation, relu and gelu,
dropout on the (M, N) view, the residual), and two runs equal in every bit.

The library's C entry (``csrc/gemm_tc.cu``) is called through ``ctypes``
here; no model path calls it. Tolerance: the f64 product's error bound of
an f32 one, 1e-5 × the output's largest entry, rtol 1e-4 (``chip_smoke.py``
``KERNEL_RTOL``); 3xTF32 keeps about f32's 24 bits in each product.

Runs on the card without JAX or this directory's conftest::

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_gemm_tc.py
"""
import ctypes

import pytest
import torch

from graphgps_torch.ops.kernels import build
from graphgps_torch.ops.kernels.common import (apply_dropout, device_seed,
                                               keep_rule)

RTOL, ATOL = 1e-4, 1e-5
SEED = 4242
# (M, N, K): GPS-deep's edge rows, the front's 7d, the pcqm4m-GPS width;
# row counts off both tile sizes
SHAPES = [(10240, 1792, 256), (1000, 768, 304), (24576, 256, 256),
          (333, 304, 304), (77, 96, 40)]
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p,
                                       ctypes.c_void_p])


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _gemm(layout, a, b, M, N, K, bias=None, res=None, pre=None, act=0,
          rate=0.0):
    """C (M, N) from the kernel; layout 0 NN, 1 NT, 2 TN."""
    dev = a.device
    c = torch.empty((M, N), device=dev)
    scratch = torch.empty(build.cfunc(
        "gemm_tc", "gemm_tc_scratch", [ctypes.c_int] * 3,
        ctypes.c_longlong)(M, N, K), device=dev)
    t, sc = keep_rule(rate)
    fn = build.cfunc("gemm_tc", "gemm_tc", ARGTYPES)
    err = fn(layout, _ptr(a), _ptr(b), _ptr(c), M, N, K, _ptr(bias), _ptr(res),
             _ptr(pre), act, build.seed_arg(device_seed(SEED, dev), t, dev), 0,
             t, sc, _ptr(scratch), build.stream_of(dev))
    build.check_launch("gemm_tc", err)
    torch.cuda.synchronize()
    return c


def _close(got, want, msg):
    torch.testing.assert_close(
        got.double(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(want.abs().max())), msg=msg)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_cuda_gemm_tc_matches_f64(cuda_device, M, N, K):
    """Each layout and epilogue piece against f64; reruns bit-identical."""
    g = torch.Generator(device=cuda_device).manual_seed(M + N + K)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)  # noqa
    a, w = rnd(M, K), rnd(K, N) / K ** 0.5
    bias, res = rnd(N), rnd(M, N)
    a64, w64 = a.double(), w.double()
    acc = a64 @ w64

    # NN, bare and with every piece: bias, pre stored, gelu, dropout, residual
    c = _gemm(0, a, w, M, N, K)
    _close(c, acc, "nn")
    assert torch.equal(c, _gemm(0, a, w, M, N, K)), "nn rerun"
    for act, name in ((1, "relu"), (2, "gelu")):
        pre = torch.empty((M, N), device=cuda_device)
        c = _gemm(0, a, w, M, N, K, bias, res, pre, act, 0.1)
        z = acc + bias.double()
        f = torch.relu if name == "relu" else torch.nn.functional.gelu
        want = apply_dropout(f(z), SEED, 0, 0.1) + res.double()
        _close(pre, z, f"nn pre {name}")
        _close(c, want, f"nn epilogue {name}")
        again = _gemm(0, a, w, M, N, K, bias, res, pre, act, 0.1)
        assert torch.equal(c, again), f"nn epilogue rerun {name}"

    # NT: G @ W^T with W (N, K), bias and residual
    wt = w.t().contiguous()
    c = _gemm(1, a, wt, M, N, K, bias, res)
    _close(c, acc + bias.double() + res.double(), "nt")
    assert torch.equal(c, _gemm(1, a, wt, M, N, K, bias, res)), "nt rerun"

    # TN: X^T @ G over the K = M rows, split into partials
    x, gr = rnd(M, K), rnd(M, N)
    c = _gemm(2, x, gr, K, N, M)
    _close(c, x.double().t() @ gr.double(), "tn")
    assert torch.equal(c, _gemm(2, x, gr, K, N, M)), "tn rerun"
