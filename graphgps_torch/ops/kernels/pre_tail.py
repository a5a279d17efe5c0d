"""Edge tail ``x_in + act(gamma*(v-mu)*inv + beta)``: the CUDA kernel
``csrc/pre_tail.cu`` (replacing ``graphgps_tpu/ops/pallas/fused_tail.py:189``
``fused_pre_tail``) and its plain PyTorch version."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import act_fn, check_rate

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def pre_tail_plain(x_in, v, mu, inv, gamma, beta, seed, rate: float,
                   act: str):
    """Plain version of :func:`fused_pre_tail`, same signature."""
    check_rate(rate)
    return x_in + act_fn(act)((v - mu) * inv * gamma + beta)


def fused_pre_tail(x_in, v, mu, inv, gamma, beta, seed, rate: float,
                   act: str):
    """x_in, v: (R, d); mu/inv/gamma/beta: (d,). Returns
    ``x_in + act(gamma*(v-mu)*inv + beta)``. ``seed``/``rate`` keep the TPU
    signature; dropout comes with training, so ``rate`` must be 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if v.device.type == "cpu":
        return pre_tail_plain(x_in, v, mu, inv, gamma, beta, seed, rate, act)
    check_rate(rate)
    if v.device.type != "cuda" or act not in build.ACTS:
        raise ValueError(f"fused_pre_tail: unsupported device {v.device} or "
                         f"act {act!r}")
    R, d = v.shape
    dev = v.device
    build.require("x_in", x_in, (R, d), dev)
    build.require("v", v, (R, d), dev)
    for name, t in (("mu", mu), ("inv", inv), ("gamma", gamma),
                    ("beta", beta)):
        build.require(name, t, (d,), dev)
    out = torch.empty_like(v)
    fn = build.load("pre_tail").pre_tail_forward
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(*map(build.ptr, (x_in, v, mu, inv, gamma, beta, out)), R, d,
             build.ACTS[act], build.stream_of(dev))
    build.check_launch("fused_pre_tail", err)
    fused_pre_tail.launches += 1
    return out


fused_pre_tail.launches = 0
