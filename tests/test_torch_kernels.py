"""The port's three kernel functions on the CPU (their plain versions)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs: ``fused_gps_front`` (rate 0), ``fused_pre_tail`` and
``fused_combine_ffn``. f32 throughout; tolerance rtol = atol = 1e-5 (the
sums run in another order; gelu's erf is exact here and a rational
approximation with |err| < 1.5e-7 inside the TPU kernels)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from graphgps_torch.ops.kernels.common import device_seed

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


def front_inputs(B=8, N=16, E=32, d=128, H=4, seed=0):
    """Blocked-layout inputs of the layer front, numpy. Graph 0 is a padded
    graph (no real node, no real edge: the partial-last-batch case); a
    padded edge points at node 0 of its own graph."""
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
                nmask=nm, cx=0.1 * f(d), cg=0.1 * f(d), ca=0.1 * f(d),
                wnq=w(d, 7 * d), bnq=0.1 * f(7 * d), wc=w(d, d), bc=0.1 * f(d),
                wo=w(d, d), bo=0.1 * f(d), H=H,
                scale=1.0 / float(d // H) ** 0.5)


_ORDER = ("x", "e", "s_loc", "r_loc", "emask", "nmask", "cx", "cg", "ca",
          "wnq", "bnq", "wc", "bc", "wo", "bo")


def test_gps_front_matches_jax():
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_layer import fused_gps_front as jfront
    from graphgps_torch.ops.kernels import fused_gps_front

    a = front_inputs()
    want = jfront(*(jnp.asarray(a[k]) for k in _ORDER),
                  jnp.zeros((), jnp.int32), a["H"], a["scale"], 0.0, 0.0)
    got = fused_gps_front(*(torch.from_numpy(a[k]) for k in _ORDER), 0,
                          a["H"], a["scale"], 0.0, 0.0)
    names = ("x_new", "gate", "s_attn", "px", "pg", "pa")
    for name, g, w in zip(names, got, want):
        assert g.shape == tuple(w.shape), name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# (act, R, d): the first two at 256 x 128; then rows of other multiples of 8
# (JAX's row blocks) at widths off 128: the backward's ragged last chunk, and
# d = 96 (TAIL_PARITY_SHAPES, shared with the other parity tests)
TAIL_PARITY_SHAPES = [(3080, 64), (1032, 96)]


def tail_parity_cases(first, shape, extra):
    """pytest params: each of ``first`` at ``shape`` with its own id (the
    ids these tests had), then each of ``extra`` at each of
    TAIL_PARITY_SHAPES."""
    return ([pytest.param(a, *shape, id=str(a)) for a in first]
            + [pytest.param(a, R, d, id=f"{a}-{R}x{d}") for a in extra
               for R, d in TAIL_PARITY_SHAPES])


@pytest.mark.parametrize("act,R,d", tail_parity_cases(
    ["relu", "gelu"], (256, 128), ["relu", "gelu"]))
def test_pre_tail_matches_jax(act, R, d):
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_tail import fused_pre_tail as jtail
    from graphgps_torch.ops.kernels import fused_pre_tail

    rng = np.random.default_rng(1)
    x, v = (rng.standard_normal((R, d)).astype(np.float32) for _ in range(2))
    mu, gamma, beta = (rng.standard_normal(d).astype(np.float32)
                       for _ in range(3))
    inv = (0.5 + rng.random(d)).astype(np.float32)
    args = (x, v, mu, inv, gamma, beta)
    want = jtail(*map(jnp.asarray, args), jnp.zeros((), jnp.int32), 0.0, act)
    got = fused_pre_tail(*map(torch.from_numpy, args), 0, 0.0, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_combine_ffn_matches_jax(act):
    import jax.numpy as jnp
    from graphgps_tpu.ops.pallas.fused_combine import (fused_combine_ffn
                                                       as jcomb)
    from graphgps_torch.ops.kernels import fused_combine_ffn

    rng = np.random.default_rng(2)
    R, d, dh = 128, 128, 256
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inv = lambda: (0.5 + rng.random(d)).astype(np.float32)  # noqa: E731
    args = (f(R, d), f(R, d), f(d), inv(), f(d), f(d),
            f(R, d), f(d), inv(), f(d), f(d),
            (f(d, dh) / np.sqrt(d)).astype(np.float32), f(dh),
            (f(dh, d) / np.sqrt(dh)).astype(np.float32), f(d))
    want = jcomb(*map(jnp.asarray, args), jnp.zeros((), jnp.int32), 0.0, act)
    got = fused_combine_ffn(*map(torch.from_numpy, args), 0, 0.0, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_combine_ffn_relu_mask_is_relu():
    """The plain version's ``relu_mask`` (the side of each FFN unit's kink
    taken from another computation, for the card tests) given this
    computation's own sides, a1 > 0, gives relu's output and gradients in
    every bit."""
    from graphgps_torch.ops.kernels.combine_ffn import (
        combine_ffn_backward_plain, combine_ffn_plain)
    from graphgps_torch.ops.kernels.common import apply_dropout

    g = torch.Generator().manual_seed(5)
    R, d = 64, 32
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    inv = lambda: 0.5 + torch.rand(d, generator=g)  # noqa: E731
    xs = (f(R, d), f(R, d), f(d), inv(), f(d), f(d), f(R, d), f(d), inv(),
          f(d), f(d), f(d, 2 * d) / d ** 0.5, f(2 * d), f(2 * d, d) / 8,
          f(d))
    conf = (3, 0.1, "relu")
    a = torch.relu((xs[1] - xs[2]) * xs[3] * xs[4] + xs[5])
    h = (xs[0] + apply_dropout(a, 3, 0, 0.1)
         + ((xs[6] - xs[7]) * xs[8] * xs[9] + xs[10]))
    mask = (h @ xs[11] + xs[12] > 0).float()
    assert torch.equal(combine_ffn_plain(*xs, *conf, mask),
                       combine_ffn_plain(*xs, *conf))
    cot = f(R, d)
    for got, want in zip(combine_ffn_backward_plain(*xs, cot, *conf, mask),
                         combine_ffn_backward_plain(*xs, cot, *conf)):
        assert torch.equal(got, want)


def test_wrappers_refuse_dropout():
    """Dropout runs inside the kernels now; a rate of 1 or more, or below
    0, is refused."""
    from graphgps_torch.ops.kernels import fused_gps_front, fused_pre_tail

    a = front_inputs(B=2, N=8, E=8)
    for attn, drop in ((1.0, 0.0), (0.1, 1.5)):
        with pytest.raises(ValueError, match="dropout"):
            fused_gps_front(*(torch.from_numpy(a[k]) for k in _ORDER), 0,
                            a["H"], a["scale"], attn, drop)
    t = torch.zeros(8, 4)
    v = torch.zeros(4)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            fused_pre_tail(t, t, v, v, v, v, 0, rate, "relu")


# The GEMM each kernel source computes its products on (README, Layout):
# the 3xTF32 tensor-core GEMM, gemm.cuh's f32 CUDA-core loop, or none (no
# dense product, or products inside the kernel's own attention body).
CSRC = Path(__file__).resolve().parents[1] / "graphgps_torch" / "csrc"
TC, FMA = "gemm_tc.cuh", "gemm.cuh"
PRODUCTS = {"gps_front": TC, "gps_attention": TC, "combine_ffn": TC,
            "gatedgcn": TC, "ln_ffn": TC, "gemm_tc": TC, "ffn": TC,
            "bn_ffn": TC, "wide_attention": FMA, "pre_tail": None,
            "drop_add": None, "edge_gate": None, "flash_mha": None,
            "segment_sum": None, "bigbird": None}


@pytest.mark.parametrize("src", sorted(p.stem for p in CSRC.glob("*.cu")))
def test_products_on_tensor_cores(src):
    """Each kernel source includes the GEMM header its products run on and
    not the other: a revert of ``gatedgcn`` or ``ln_ffn`` to the CUDA-core
    GEMM fails here, on the CPU. A new source needs its entry."""
    assert src in PRODUCTS, f"{src}.cu: add it to PRODUCTS and the README"
    text = (CSRC / f"{src}.cu").read_text()
    included = set(re.findall(r'^#include "([^"]+)"', text, re.M))
    assert included & {TC, FMA} == ({PRODUCTS[src]} - {None})


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On the card: each forward kernel, and with dropout 0.1 each backward
    kernel, against its plain version on the same tensors (the backward's is
    autograd through the plain forward with the same masks), and one launch
    counted per call. f32; rtol = atol = 1e-4 for another summation order,
    a gradient's atol scaled by its tensor's largest entry (its entries are
    sums over rows); the front's (1, 2d) moment sums, which cancel towards
    0 in their first half, within 1e-5 of their largest entry. Two runs of
    a backward kernel give the same bits.

    Runs on the card without JAX or this directory's conftest:
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_kernels.py``."""
    from graphgps_torch.ops.kernels import (combine_ffn_backward,
                                            gps_front_backward,
                                            pre_tail_backward)
    from graphgps_torch.ops.kernels.combine_ffn import (combine_ffn_plain,
                                                         fused_combine_ffn)
    from graphgps_torch.ops.kernels.gps_front import (fused_gps_front,
                                                       gps_front_plain)
    from graphgps_torch.ops.kernels.pre_tail import (fused_pre_tail,
                                                      pre_tail_plain)

    d = 256
    a = front_inputs(B=16, N=40, E=96, d=d, H=8)
    front = tuple(torch.from_numpy(a[k]).to(cuda_device) for k in _ORDER)
    g = torch.Generator().manual_seed(3)
    f = lambda *s: torch.randn(*s, generator=g).to(cuda_device)  # noqa: E731
    inv = lambda: (0.5 + torch.rand(d, generator=g)).to(cuda_device)  # noqa
    R = 16 * 40
    tail = (f(R, d), f(R, d), f(d), inv(), f(d), f(d))
    comb = (f(R, d), f(R, d), f(d), inv(), f(d), f(d), f(R, d), f(d), inv(),
            f(d), f(d), f(d, 2 * d) / 16, f(2 * d), f(2 * d, d) / 23, f(d))
    seed = device_seed(7, cuda_device)
    cases = ((fused_gps_front, gps_front_plain, gps_front_backward, front,
              (seed, a["H"], a["scale"])),
             (fused_pre_tail, pre_tail_plain, pre_tail_backward, tail,
              (seed,)),
             (fused_combine_ffn, combine_ffn_plain, combine_ffn_backward,
              comb, (seed,)))
    for fused, plain, bwd, xs, head in cases:
        rates = (0.0, 0.0) if fused is fused_gps_front else (0.0,)
        extra = (*head, *rates) + (("gelu",) if fused is not fused_gps_front
                                   else ())
        before = fused.launches
        got, want = fused(*xs, *extra), plain(*xs, *extra)
        assert fused.launches == before + 1
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for gt, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(gt, w, rtol=1e-4, atol=1e-4)
        for gt, w in zip(got[3:], want[3:]):
            torch.testing.assert_close(gt, w, rtol=0.0,
                                       atol=1e-5 * float(w.abs().max()))

        # backward with dropout 0.1 on every site
        rates = (0.1, 0.1) if fused is fused_gps_front else (0.1,)
        extra = (*head, *rates) + (("gelu",) if fused is not fused_gps_front
                                   else ())
        diff = [i for i, t in enumerate(xs) if t.dtype == torch.float32
                and (fused is not fused_gps_front
                     or i in (0, 1, 9, 10, 11, 12, 13, 14))]
        ins = [t.clone().requires_grad_() if i in diff else t
               for i, t in enumerate(xs)]
        outs = fused(*ins, *extra)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [torch.randn(o.shape, generator=g).to(cuda_device)
                for o in outs]
        before = bwd.launches
        got = torch.autograd.grad(outs, [ins[i] for i in diff], cots)
        assert bwd.launches == before + 1
        again = torch.autograd.grad(
            fused(*ins, *extra), [ins[i] for i in diff],
            cots if len(cots) > 1 else cots[0])
        with torch.enable_grad():
            pins = [t.detach().clone().requires_grad_() if i in diff else t
                    for i, t in enumerate(xs)]
            pouts = plain(*pins, *extra)
            want = torch.autograd.grad(pouts, [pins[i] for i in diff], cots)
        for gt, ag, w in zip(got, again, want):
            assert torch.equal(gt, ag)
            torch.testing.assert_close(gt, w, rtol=1e-4,
                                       atol=1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("R,d", [(10240, 256), (1280, 64), (10240, 304)],
                         ids=["G", "M", "P"])
def test_cuda_combine_ffn_matches_plain(cuda_device, R, d, act):
    """On the card: ``combine_ffn``, whose FFN products run on the 3xTF32
    tensor-core GEMM, at GPS-deep's (G), ogbg-molhiv's (M) and pcqm4m-GPS's
    (P) rows and widths, dh = 2d, dropout 0.1 on every site, forward and
    backward against its plain version at the tolerances above, one launch
    per call, two backward runs equal in every bit. With relu the plain
    version takes the kernel's side of each kink of the FFN (``relu_mask``
    from the kernel's kept a1 > 0), and a unit whose side differs lies
    within 1e-5 of the pre-activations' largest entry from 0.
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_kernels.py``."""
    from graphgps_torch.ops.kernels import combine_ffn as cf

    g = torch.Generator().manual_seed(4)
    f = lambda *s: torch.randn(*s, generator=g).to(cuda_device)  # noqa: E731
    inv = lambda: (0.5 + torch.rand(d, generator=g)).to(cuda_device)  # noqa
    xs = (f(R, d), f(R, d), f(d), inv(), f(d), f(d), f(R, d), f(d), inv(),
          f(d), f(d), f(d, 2 * d) / d ** 0.5, f(2 * d) * 0.1,
          f(2 * d, d) / (2 * d) ** 0.5, f(d))
    conf = (device_seed(7, cuda_device), 0.1, act)
    before = cf.fused_combine_ffn.launches
    out, h, z, a1 = cf._launch_forward(xs, *conf, True)
    assert cf.fused_combine_ffn.launches == before + 1
    mask = None
    if act == "relu":
        mask = (a1 > 0).float()
        flips = (h @ xs[11] + xs[12] > 0).float() != mask
        if bool(flips.any()):
            assert float(a1[flips].abs().max()) <= 1e-5 * float(a1.abs().max())
    torch.testing.assert_close(out, cf.combine_ffn_plain(*xs, *conf, mask),
                               rtol=1e-4, atol=1e-4)
    cot = torch.randn(R, d, generator=g).to(cuda_device)
    before = cf.combine_ffn_backward.launches
    got = cf.combine_ffn_backward(*xs, cot, *conf, kept=(h, a1, z))
    again = cf.combine_ffn_backward(*xs, cot, *conf, kept=(h, a1, z))
    assert cf.combine_ffn_backward.launches == before + 2
    want = cf.combine_ffn_backward_plain(*xs, cot, *conf, mask)
    for gt, ag, w in zip(got, again, want):
        assert torch.equal(gt, ag)
        torch.testing.assert_close(gt, w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))


def _offset_copy(t, offset: int):
    """A contiguous copy of ``t`` whose storage starts ``offset`` floats
    into a fresh buffer: a base that is not 16-byte aligned for offset 1."""
    buf = torch.empty(t.numel() + offset, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _tail_inputs(R, d, device, seed):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g).to(device)  # noqa: E731
    inv = (0.5 + torch.rand(d, generator=g)).to(device)
    return (f(R, d), f(R, d), f(d), inv, f(d), f(d)), f(R, d)


# (R, d, act, offset): M (ogbg-molhiv's edge tail, float4 columns); rows that
# are no multiple of the backward's row chunk; d = 66 on an odd row count
# (neither d nor the view a multiple of 4: float4 rows with a scalar tail
# forward, one column a thread backward); a base off 16 bytes (floats
# throughout); d below 4; and GPS-deep's edge tail (G: 4 vectors a thread)
TAIL_SHAPES = [(3072, 64, "relu", 0), (3000, 64, "gelu", 0),
               (1001, 66, "relu", 0), (3072, 64, "relu", 1),
               (77, 3, "gelu", 0), (24576, 256, "gelu", 0)]
TAIL_IDS = ["M", "ragged-rows", "d66", "misaligned", "d3", "G"]


@pytest.mark.cuda
@pytest.mark.parametrize("R,d,act,offset", TAIL_SHAPES, ids=TAIL_IDS)
def test_cuda_pre_tail_drop_add_match_plain(cuda_device, R, d, act, offset):
    """On the card: ``pre_tail`` and ``drop_add``, forward and backward with
    dropout 0.1, against their plain versions on the same tensors at 3b's
    tolerances (rtol = atol = 1e-4, a gradient's atol times max(1, its
    largest entry)), one launch counted per call, two backward runs equal in
    every bit; and each forward's and backward's elementwise outputs equal
    in every bit to the same call on copies whose bases are 16 bytes off
    (the vectorised and the scalar bodies run the same arithmetic).
    ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
    tests/test_torch_kernels.py``."""
    from graphgps_torch.ops.kernels import drop_add, pre_tail

    conf = (device_seed(7, cuda_device), 0.1, act)
    (x, v, *norm), cot = _tail_inputs(R, d, cuda_device, 8)
    if offset:
        x, v, cot = (_offset_copy(t, offset) for t in (x, v, cot))
        norm = [_offset_copy(t, offset) for t in norm]
    before = pre_tail.fused_pre_tail.launches
    out = pre_tail.fused_pre_tail(x, v, *norm, *conf)
    assert pre_tail.fused_pre_tail.launches == before + 1
    torch.testing.assert_close(out, pre_tail.pre_tail_plain(x, v, *norm,
                                                            *conf),
                               rtol=1e-4, atol=1e-4)
    before = pre_tail.pre_tail_backward.launches
    got = pre_tail.pre_tail_backward(v, *norm, cot, *conf)
    again = pre_tail.pre_tail_backward(v, *norm, cot, *conf)
    assert pre_tail.pre_tail_backward.launches == before + 2
    want = pre_tail.pre_tail_backward_plain(v, *norm, cot, *conf)
    for gt, ag, w in zip(got, again, want):
        assert torch.equal(gt, ag)
        torch.testing.assert_close(gt, w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    moved = [_offset_copy(t, 1 - offset) for t in (x, v, cot, *norm)]
    assert torch.equal(out, pre_tail.fused_pre_tail(*moved[:2], *moved[3:],
                                                    *conf))
    assert torch.equal(got[0], pre_tail.pre_tail_backward(
        moved[1], *moved[3:], moved[2], *conf)[0])

    before = (drop_add.fused_drop_add.launches,
              drop_add.drop_add_backward.launches)
    out = drop_add.fused_drop_add(x, v, *conf[:2])
    dv = drop_add.drop_add_backward(cot, *conf[:2])
    assert (drop_add.fused_drop_add.launches,
            drop_add.drop_add_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    torch.testing.assert_close(out, drop_add.drop_add_plain(x, v, *conf[:2]),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, drop_add.drop_add_backward_plain(
        cot, *conf[:2]), rtol=1e-4, atol=1e-4)
    assert torch.equal(dv, drop_add.drop_add_backward(cot, *conf[:2]))
    assert torch.equal(out, drop_add.fused_drop_add(*moved[:2], *conf[:2]))
    assert torch.equal(dv, drop_add.drop_add_backward(moved[2], *conf[:2]))


@pytest.mark.cuda
def test_cuda_pre_tail_backward_one_launch_and_graph(cuda_device):
    """On the card: ``pre_tail_backward`` is one CUDA kernel launch a call
    (the profiler's count at M); back-to-back calls at two shapes with other
    slab counts (d 304, then 64) each give their plain version's sums (every
    launch leaves its slabs' tickets at 0); and a CUDA graph capture of the
    call replays to the eager call's bits."""
    from graphgps_torch.ops.kernels import pre_tail

    conf = (device_seed(11, cuda_device), 0.1, "relu")
    (_, v, *norm), cot = _tail_inputs(3072, 64, cuda_device, 9)
    pre_tail.pre_tail_backward(v, *norm, cot, *conf)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eager = pre_tail.pre_tail_backward(v, *norm, cot, *conf)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert launches == 1

    (_, v2, *norm2), cot2 = _tail_inputs(4000, 304, cuda_device, 10)
    for args in ((v2, *norm2, cot2), (v, *norm, cot)):
        got = pre_tail.pre_tail_backward(*args, *conf)
        want = pre_tail.pre_tail_backward_plain(*args, *conf)
        for gt, w in zip(got, want):
            torch.testing.assert_close(
                gt, w, rtol=1e-4, atol=1e-4 * max(1.0, float(w.abs().max())))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pre_tail.pre_tail_backward(v, *norm, cot, *conf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pre_tail.pre_tail_backward(v, *norm, cot, *conf)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for c, e in zip(captured, eager):
            assert torch.equal(c, e)
