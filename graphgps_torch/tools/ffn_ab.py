#!/usr/bin/env python3
"""Device times of the FFN-block kernels of two checkouts, in turns, on one
GPU: ``combine_ffn`` and ``bn_ffn``, forward and backward, at the shapes of
``chip_smoke.py`` phases 3, 3c and 3f. Used to hold a change to their
shared FFN body (``csrc/ffn_core.cuh``) to its parent's times.

Usage, from anywhere, each ROOT a checkout holding ``graphgps_torch/``::

    python graphgps_torch/tools/ffn_ab.py PARENT CHANGE CHANGE PARENT

Each ROOT runs in a process of its own that imports ``graphgps_torch`` from
ROOT and builds its kernels there (``ROOT/build/kernels``). Per kernel and
shape it prints one JSON line per run (device ms per call by
``torch.profiler`` over 50 calls after 5 warm-ups, seeded inputs, dropout
0.1 on every site), then one summary line per kernel and shape: the mean ms
of each ROOT and the ratio of the last distinct ROOT to the first, with the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

# (tag, rows, width): phase 3's GPS-deep layer (batch 256 x 40 node
# slots, d 256), 3c's ogbg-molhiv (32 x 40, d 64) and pcqm4m-GPS (256 x
# 40, d 304), 3f's molhiv SAN (64 x 40, d 64) and the molpcba-SAN width
# (512 x 40, d 304)
SHAPES = {"combine_ffn": [("G", 10240, 256), ("M", 1280, 64),
                          ("P", 10240, 304)],
          "bn_ffn": [("S", 2560, 64), ("W", 20480, 304)]}
ITERS, WARMUP, RATE, SEED = 50, 5, 0.1, 20260


def _time(torch, fn) -> float:
    """Device ms per call of ``fn``: the CUDA kernels it launches, summed
    by ``torch.profiler`` over ITERS calls, so that the host's launch gaps
    (which decide a back-to-back timing at small shapes) do not count."""
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
        raise SystemExit("ffn_ab: the profiler recorded no device time")
    return us / ITERS / 1e3


def _run_one(root: str) -> None:
    """Time every kernel and shape with ``graphgps_torch`` from ``root``."""
    sys.path.insert(0, root)
    import torch

    from graphgps_torch.ops.kernels import bn_ffn, build, combine_ffn

    if not torch.cuda.is_available():
        raise SystemExit("ffn_ab: no CUDA device")
    build.build_all(["combine_ffn", "bn_ffn"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    for name, shapes in SHAPES.items():
        for tag, R, d in shapes:
            dh = 2 * d
            vec = lambda: rnd(d, scale=0.1)  # noqa: E731
            pos = lambda: 1.0 + rnd(d, scale=0.1).abs()  # noqa: E731
            ffn_w = (rnd(d, dh, scale=d ** -0.5), vec().repeat(2),
                     rnd(dh, d, scale=dh ** -0.5), vec())
            if name == "combine_ffn":
                args = (rnd(R, d), rnd(R, d), vec(), pos(), pos(), vec(),
                        rnd(R, d), vec(), pos(), pos(), vec(), *ffn_w)
                conf = (SEED, RATE, "relu")
                fwd = lambda: combine_ffn._launch_forward(  # noqa: E731
                    args, *conf, True)
                out, h, z, a1 = fwd()
                cot = rnd(R, d)
                bwd = lambda: combine_ffn.combine_ffn_backward(  # noqa: E731
                    *args, cot, *conf, kept=(h, a1, z))
            else:
                args = (rnd(R, d), vec(), pos(), pos(), vec(), *ffn_w)
                conf = (SEED, RATE, "relu", True)
                fwd = lambda: bn_ffn._launch_forward(  # noqa: E731
                    args, *conf, True)
                out, kept = fwd()
                cot = rnd(R, d)
                bwd = lambda: bn_ffn.bn_ffn_backward(  # noqa: E731
                    *args, cot, *conf, kept=kept)
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                print(json.dumps(dict(root=root, kernel=f"{name}_{kind}",
                                      shape=tag, R=R, d=d,
                                      ms=_time(torch, fn))), flush=True)


def main(roots) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"ffn_ab: {root} failed:\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    first, last = roots[0], [r for r in roots if r != roots[0]][-1]
    for key in sorted({(r["kernel"], r["shape"]) for r in rows}):
        mean = {root: sum(r["ms"] for r in rows if r["root"] == root
                          and (r["kernel"], r["shape"]) == key)
                / roots.count(root) for root in dict.fromkeys(roots)}
        print(json.dumps(dict(kernel=key[0], shape=key[1], mean_ms=mean,
                              ratio=mean[last] / mean[first], card=smi)),
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        _run_one(sys.argv[2])
    elif len(sys.argv) >= 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
