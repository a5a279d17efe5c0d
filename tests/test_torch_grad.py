"""The port's three kernel functions, forward and backward, with dropout on,
against the JAX package's Pallas kernels in interpret mode on the same numpy
inputs; and the port's dropout rule itself.

The TPU kernels' random bits cannot be reproduced, so the JAX side runs with
its ``_keep`` (imported by name into ``fused_layer`` and ``fused_combine``,
so all three module attributes are patched) replaced by the port's rule:
the counter hash of (seed, site, global row, column) over each site's 2-D
view, the global row of a block being ``program_id(0) * rows + iota``. Each
JAX kernel then draws exactly the port's masks, whatever its block shape.

Tolerance, f32: rtol = 1e-5 and atol = 1e-5 × max(1, max |reference|) per
tensor. The sums run in another order, and gelu's erf is exact in the port
and a rational approximation with |err| < 1.5e-7 inside the TPU kernels.
The atol scales with the tensor because a gradient entry is a sum of
hundreds to thousands of terms (dx: 7d = 896 products per entry; a weight
gradient: one per row) that cancel, so its f32 rounding follows the
magnitude of the terms, not of the entry: with a flat atol of 1e-5, 2 of
16,384 entries of dx (values up to 9) missed by 3.9e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.test_torch_kernels import _ORDER, front_inputs, tail_parity_cases

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
RATE = 0.1
SEED = 12345


def _mix32(x):
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def port_keep(seed_ref, offset, shape, rate):
    """The port's dropout rule (graphgps_torch/ops/kernels/common.py) with
    the JAX ``_keep`` signature, for views of fewer than 2^32 elements."""
    t = min(max(int(round(rate * 256)), 1), 255)
    u32 = jnp.uint32
    key = _mix32(seed_ref[0].astype(u32) + u32(0x9E3779B9) * u32(offset + 1))
    row = (pl.program_id(0).astype(u32) * u32(shape[0])
           + jax.lax.broadcasted_iota(u32, shape, 0))
    idx = row * u32(shape[1]) + jax.lax.broadcasted_iota(u32, shape, 1)
    bits = _mix32(idx ^ _mix32(key))          # the counter's high word is 0
    keep = ((bits & u32(255)) >= u32(t)).astype(jnp.float32)
    return keep, 1.0 / (1.0 - t / 256.0)


@pytest.fixture
def port_masks(monkeypatch):
    from graphgps_tpu.ops.pallas import fused_combine, fused_layer, fused_tail

    for mod in (fused_tail, fused_layer, fused_combine):
        monkeypatch.setattr(mod, "_keep", port_keep)
    return monkeypatch


def _cotangents(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_vjp(fn, diff, cots):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, diff))
    cots = tuple(map(jnp.asarray, cots))
    return out, vjp(cots if isinstance(out, tuple) else cots[0])


def _torch_vjp(fn, diff, cots):
    ins = [torch.from_numpy(a).requires_grad_() for a in diff]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, ins, [torch.from_numpy(c) for c in cots])
    return out, grads


def _assert_close(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy()
        assert np.isfinite(g).all(), name
        w = np.asarray(w)
        atol = ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=name)


def test_gps_front_fwd_bwd_with_dropout_match_jax(port_masks):
    """Two grid steps on the JAX side (GGPS_LAYER_G=4 of B=8), graph 0 fully
    padded; random cotangents for all six outputs, moment partials too. The
    JAX output without the patch differs: the patched masks were used."""
    from graphgps_tpu.ops.pallas.fused_layer import fused_gps_front as jfront
    from graphgps_torch.ops.kernels import fused_gps_front

    port_masks.setenv("GGPS_LAYER_G", "4")
    a = front_inputs()
    H, scale = a["H"], a["scale"]
    names = ("x", "e", "wnq", "bnq", "wc", "bc", "wo", "bo")
    diff = [a[k] for k in names]
    rest = {k: a[k] for k in _ORDER if k not in names}

    def args(d, conv):
        m = dict(zip(names, d), **{k: conv(v) for k, v in rest.items()})
        return [m[k] for k in _ORDER]

    def jfn(*d):
        return jfront(*args(d, jnp.asarray), jnp.asarray(SEED, jnp.int32), H,
                      scale, RATE, RATE)

    def tfn(*d):
        return fused_gps_front(*args(d, torch.from_numpy), SEED, H, scale,
                               RATE, RATE)

    rng = np.random.default_rng(7)
    B, N, d = a["x"].shape
    E = a["e"].shape[1]
    cots = _cotangents(rng, [(B, N, d), (B, E, d), (B, N, d), (1, 2 * d),
                             (1, 2 * d), (1, 2 * d)])
    want_out, want_grads = _jax_vjp(jfn, diff, cots)
    got_out, got_grads = _torch_vjp(tfn, diff, cots)
    _assert_close(got_out, want_out,
                  ("x_new", "gate", "s_attn", "px", "pg", "pa"))
    _assert_close(got_grads, want_grads, [f"d{n}" for n in names])
    # padded graph 0: zero gradient on its rows where JAX gives zero
    assert float(got_grads[0][0].abs().max()) == pytest.approx(
        float(np.abs(np.asarray(want_grads[0][0])).max()), abs=ATOL)

    port_masks.undo()
    default = jfn(*map(jnp.asarray, diff))
    assert not np.allclose(np.asarray(default[2]), np.asarray(want_out[2]),
                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act,R,d", tail_parity_cases(
    ["relu", "gelu"], (2048, 128), ["relu", "gelu"]))
def test_pre_tail_fwd_bwd_with_dropout_match_jax(port_masks, act, R, d):
    """R = 2048 rows of 128: two row blocks on the JAX side; and 3,080 x 64
    and 1,032 x 96 (5 and 3 row blocks)."""
    from graphgps_tpu.ops.pallas.fused_tail import fused_pre_tail as jtail
    from graphgps_torch.ops.kernels import fused_pre_tail

    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    diff = [f(R, d), f(R, d), f(d), (0.5 + rng.random(d)).astype(np.float32),
            f(d), f(d)]
    cots = _cotangents(rng, [(R, d)])
    want_out, want_grads = _jax_vjp(
        lambda *t: jtail(*t, jnp.asarray(SEED, jnp.int32), RATE, act), diff,
        cots)
    got_out, got_grads = _torch_vjp(
        lambda *t: fused_pre_tail(*t, SEED, RATE, act), diff, cots)
    _assert_close(got_out, [want_out], ["out"])
    _assert_close(got_grads, want_grads,
                  ["dx_in", "dv", "dmu", "dinv", "dgamma", "dbeta"])


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_combine_ffn_fwd_bwd_with_dropout_match_jax(port_masks, act):
    """R = 1024 rows: two row blocks on the JAX side; all three sites."""
    from graphgps_tpu.ops.pallas.fused_combine import (fused_combine_ffn
                                                       as jcomb)
    from graphgps_torch.ops.kernels import fused_combine_ffn

    rng = np.random.default_rng(2)
    R, d, dh = 1024, 128, 256
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inv = lambda: (0.5 + rng.random(d)).astype(np.float32)  # noqa: E731
    diff = [f(R, d), f(R, d), f(d), inv(), f(d), f(d),
            f(R, d), f(d), inv(), f(d), f(d),
            (f(d, dh) / np.sqrt(d)).astype(np.float32), f(dh),
            (f(dh, d) / np.sqrt(dh)).astype(np.float32), f(d)]
    cots = _cotangents(rng, [(R, d)])
    want_out, want_grads = _jax_vjp(
        lambda *t: jcomb(*t, jnp.asarray(SEED, jnp.int32), RATE, act), diff,
        cots)
    got_out, got_grads = _torch_vjp(
        lambda *t: fused_combine_ffn(*t, SEED, RATE, act), diff, cots)
    _assert_close(got_out, [want_out], ["out"])
    _assert_close(got_grads, want_grads,
                  ["dx_in", "dv_loc", "dmu_x", "dinv_x", "dga_x", "dbe_x",
                   "ds_attn", "dmu_a", "dinv_a", "dga_a", "dbe_a", "dw1",
                   "db1", "dw2", "db2"])


# --- the dropout rule itself -------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _np_mix32(x):
    x = np.asarray(x, np.uint64) & _M32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _M32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _M32
    return x ^ (x >> np.uint64(16))


@pytest.mark.parametrize("row0", [0, 2 ** 30 + 7])
def test_drop_bits_match_uint_reference(row0):
    """The torch int64 hash equals a numpy uint64 reference bit for bit,
    also where the 64-bit counter row·cols + col has a high word."""
    from graphgps_torch.ops.kernels.common import drop_bits

    seed, site, rows, cols = 987654321, 2, 5, 33
    key = _np_mix32((seed + 0x9E3779B9 * (site + 1)) & 0xFFFFFFFF)
    r = np.arange(row0, row0 + rows, dtype=np.uint64)[:, None]
    idx = r * np.uint64(cols) + np.arange(cols, dtype=np.uint64)[None]
    want = _np_mix32((idx & _M32) ^ _np_mix32((idx >> np.uint64(32)) ^ key))
    got = drop_bits(seed, site, rows, cols, row0=row0)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_mask_is_independent_of_the_view_split():
    """A site's mask over rows [0, R) equals the masks of its row blocks
    stacked: it depends on (seed, site, row, col) only, not on the tiling."""
    from graphgps_torch.ops.kernels.common import drop_bits

    whole = drop_bits(5, 1, 96, 40)
    blocks = torch.cat([drop_bits(5, 1, 32, 40, row0=r) for r in (0, 32, 64)])
    assert torch.equal(whole, blocks)
    assert not torch.equal(whole, drop_bits(5, 0, 96, 40))
    assert not torch.equal(whole, drop_bits(6, 1, 96, 40))


def test_keep_rule_fraction_and_scale():
    """The u8 grid at rate 0.1: t = 26, kept fraction 230/256 (within 0.5%
    over 4M draws), kept values scaled by 256/230 in f32; rate 0 is no
    dropout; rates outside [0, 1) raise."""
    from graphgps_torch.ops.kernels.common import (apply_dropout,
                                                    dropout_mask, keep_rule)

    t, scale = keep_rule(RATE)
    assert t == 26 and scale == np.float32(256 / 230)
    m = dropout_mask(SEED, 0, 2048, 2048, RATE)
    assert abs(float((m > 0).float().mean()) - 230 / 256) < 0.005 * 230 / 256
    assert set(torch.unique(m).tolist()) == {0.0, scale}
    assert keep_rule(0.0) == (0, 1.0) and dropout_mask(1, 0, 4, 4, 0.0) is None
    v = torch.ones(4, 4)
    assert apply_dropout(v, 1, 0, 0.0) is v
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="outside"):
            keep_rule(bad)
