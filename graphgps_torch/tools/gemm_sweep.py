#!/usr/bin/env python3
"""Device times of the tensor-core GEMM (``csrc/gemm_tc.cuh``: 3xTF32
``mma.sync``) at the products of ``gps_front`` and ``gps_attention`` on
GPS-deep's layer (10,240 node rows, 24,576 edge rows, d 256) and at those
of ``ln_ffn`` on the ZINC Graphormer's (10,496 rows, d = dh = 80; the
forward's NN with each epilogue it uses), beside one f32
``torch.matmul`` of the same product (the library's yardstick; the port
never calls it) and the product's error over its largest entry against an
f64 ``torch.matmul``.

Usage, on a machine with a card, from the repository root::

    python graphgps_torch/tools/gemm_sweep.py

One JSON line per product: layout (NN forward, NT input gradient, TN
weight gradient split over rows), M, N, K, the epilogue, device ms per
call of each (``torch.profiler`` over 20 calls after 3 warm-ups), TFLOP/s,
the error (of the product without an epilogue), and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from graphgps_torch.ops.kernels import build  # noqa: E402

# (layout, M, N, K): 0 NN, 1 NT, 2 TN
SHAPES = [(0, 10240, 768, 256), (0, 10240, 1792, 256), (0, 24576, 256, 256),
          (0, 10240, 256, 256), (1, 10240, 256, 1792), (1, 10240, 256, 768),
          (1, 24576, 256, 256), (1, 10240, 256, 256), (2, 256, 1792, 10240),
          (2, 256, 768, 10240), (2, 256, 256, 24576), (2, 256, 256, 10240)]
# ln_ffn's products at ZINC (R 10,496, d = dh = 80)
ZINC_SHAPES = [(0, 10496, 80, 80), (1, 10496, 80, 80), (2, 80, 80, 10496)]
# the NN forward's epilogues: none; the bias; ln_ffn's first product (bias,
# gelu, dropout 0.1, the pre-activation kept); its second (bias, dropout
# 0.1, the residual)
EPILOGUES = {"none": {}, "bias": dict(bias=True),
             "bias+gelu+drop+pre": dict(bias=True, act=2, drop=True, pre=True),
             "bias+drop+res": dict(bias=True, drop=True, res=True)}
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_uint32,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p,
                                       ctypes.c_void_p])
ITERS, WARMUP = 20, 3


def device_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise SystemExit("gemm_sweep: the profiler recorded no device time")
    return us / ITERS / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False   # the library in full f32
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    fn = build.cfunc("gemm_tc", "gemm_tc", ARGTYPES)
    scratch_of = build.cfunc("gemm_tc", "gemm_tc_scratch", [ctypes.c_int] * 3,
                             ctypes.c_longlong)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    for lay, M, N, K in SHAPES + ZINC_SHAPES:
        a = torch.randn(*((K, M) if lay == 2 else (M, K)), generator=g,
                        device=dev)
        b = torch.randn(*((N, K) if lay == 1 else (K, N)), generator=g,
                        device=dev)
        at = a.t() if lay == 2 else a
        bt = b.t() if lay == 1 else b
        c = torch.empty(M, N, device=dev)
        scratch = torch.empty(max(1, scratch_of(M, N, K)), device=dev)
        stream = build.stream_of(dev)

        epi_t = dict(bias=torch.randn(N, generator=g, device=dev),
                     res=torch.randn(M, N, generator=g, device=dev),
                     pre=torch.empty(M, N, device=dev))

        def call(act=0, drop=False, **on):
            opt = lambda k: ptr(epi_t[k]) if on.get(k) else None  # noqa
            build.check_launch("gemm_tc", fn(
                lay, ptr(a), ptr(b), ptr(c), M, N, K, opt("bias"), opt("res"),
                opt("pre"), act, 7, 1, 26 if drop else 0,
                256 / 230 if drop else 1.0, ptr(scratch), stream))

        call()
        want = at.double() @ bt.double()
        err = float((c.double() - want).abs().max() / want.abs().max())
        lib = device_ms(lambda: at @ bt)
        flop = 2.0 * M * N * K
        zinc = (lay, M, N, K) in ZINC_SHAPES
        for epi, kw in (EPILOGUES.items() if zinc and lay == 0
                        else [("none", {})]):
            ms = device_ms(lambda: call(**kw))
            print(json.dumps(dict(layout="NN NT TN".split()[lay], M=M, N=N,
                                  K=K, epilogue=epi, ms=ms,
                                  tflops=flop / ms / 1e9, library_ms=lib,
                                  library_tflops=flop / lib / 1e9,
                                  err_over_max=err, card=card)), flush=True)


if __name__ == "__main__":
    main()
