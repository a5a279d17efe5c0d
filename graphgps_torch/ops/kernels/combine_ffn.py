"""GPS layer branch combine + FFN: the CUDA kernel ``csrc/combine_ffn.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_combine.py:183``
``fused_combine_ffn``) and its plain PyTorch version."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import act_fn, check_rate, true_f32

_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def combine_ffn_plain(x_in, v_loc, mu_x, inv_x, ga_x, be_x,
                      s_attn, mu_a, inv_a, ga_a, be_a,
                      w1, b1, w2, b2, seed, rate: float, act: str):
    """Plain version of :func:`fused_combine_ffn`, same signature."""
    check_rate(rate)
    true_f32()
    a = act_fn(act)
    h = (x_in + a((v_loc - mu_x) * inv_x * ga_x + be_x)
         + ((s_attn - mu_a) * inv_a * ga_a + be_a))
    return h + (a(h @ w1 + b1) @ w2 + b2)


def fused_combine_ffn(x_in, v_loc, mu_x, inv_x, ga_x, be_x,
                      s_attn, mu_a, inv_a, ga_a, be_a,
                      w1, b1, w2, b2, seed, rate: float, act: str):
    """x_in, v_loc, s_attn: (R, d); the norm vectors: (d,); w1: (d, dh);
    b1: (dh,); w2: (dh, d); b2: (d,) -- (in, out) weights as in the JAX
    package. Returns ``h + W2 act(W1 h + b1) + b2`` with
    ``h = x_in + act(bn_x(v_loc)) + bn_a(s_attn)``. ``rate`` must be 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    args = (x_in, v_loc, mu_x, inv_x, ga_x, be_x, s_attn, mu_a, inv_a, ga_a,
            be_a, w1, b1, w2, b2)
    if x_in.device.type == "cpu":
        return combine_ffn_plain(*args, seed, rate, act)
    check_rate(rate)
    if x_in.device.type != "cuda" or act not in build.ACTS:
        raise ValueError(f"fused_combine_ffn: unsupported device "
                         f"{x_in.device} or act {act!r}")
    R, d = x_in.shape
    dh = w1.shape[1]
    dev = x_in.device
    for name, t in (("x_in", x_in), ("v_loc", v_loc), ("s_attn", s_attn)):
        build.require(name, t, (R, d), dev)
    for name, t in (("mu_x", mu_x), ("inv_x", inv_x), ("ga_x", ga_x),
                    ("be_x", be_x), ("mu_a", mu_a), ("inv_a", inv_a),
                    ("ga_a", ga_a), ("be_a", be_a), ("b2", b2)):
        build.require(name, t, (d,), dev)
    build.require("w1", w1, (d, dh), dev)
    build.require("b1", b1, (dh,), dev)
    build.require("w2", w2, (dh, d), dev)
    out = torch.empty_like(x_in)
    h = torch.empty_like(x_in)
    z = torch.empty((R, dh), device=dev, dtype=torch.float32)
    fn = build.load("combine_ffn").combine_ffn_forward
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(*map(build.ptr, args + (out, h, z)), R, d, dh, build.ACTS[act],
             build.stream_of(dev))
    build.check_launch("fused_combine_ffn", err)
    fused_combine_ffn.launches += 1
    return out


fused_combine_ffn.launches = 0
