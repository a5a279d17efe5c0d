#!/usr/bin/env python3
"""Device times and output bits of kernels of two checkouts, in turns, on
one GPU: the FFN-block kernels ``combine_ffn`` and ``bn_ffn`` and the layer
front ``gps_front``, forward and backward, at the shapes of
``chip_smoke.py`` phases 3, 3c and 3f. Used to hold a change to a shared
body (``csrc/ffn_core.cuh``, ``csrc/mha_core.cuh``) to its parent's times
and bits.

Usage, from anywhere, each ROOT a checkout holding ``graphgps_torch/``::

    python graphgps_torch/tools/kernel_ab.py [--kernels a,b] PARENT CHANGE CHANGE PARENT

Each ROOT runs in a process of its own that imports ``graphgps_torch`` from
ROOT and builds its kernels there (``ROOT/build/kernels``). Per kernel and
shape it prints one JSON line per run (device ms per call by
``torch.profiler`` over 50 calls after 5 warm-ups, seeded inputs, dropout
0.1 on every site, and a sha256 of the outputs' bytes), then one summary
line per kernel and shape: the mean ms of each ROOT, the ratio of the last
distinct ROOT to the first, whether every run gave the same bits, and the
card's name and power limit. ``--kernels`` picks some of
``combine_ffn``, ``bn_ffn``, ``gps_front`` (by default all).
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

# (tag, rows, width): phase 3's GPS-deep layer (batch 256 x 40 node
# slots, d 256), 3c's ogbg-molhiv (32 x 40, d 64) and pcqm4m-GPS (256 x
# 40, d 304), 3f's molhiv SAN (64 x 40, d 64) and the molpcba-SAN width
# (512 x 40, d 304); gps_front at GPS-deep's layer (batch 256, 40 node
# slots, 96 edge slots, d 256, 8 heads)
SHAPES = {"combine_ffn": [("G", 10240, 256), ("M", 1280, 64),
                          ("P", 10240, 304)],
          "bn_ffn": [("S", 2560, 64), ("W", 20480, 304)],
          "gps_front": [("G", 10240, 256)]}
FRONT_GRAPHS, FRONT_NODES, FRONT_EDGES, FRONT_HEADS = 256, 40, 96, 8
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
        raise SystemExit("kernel_ab: the profiler recorded no device time")
    return us / ITERS / 1e3


def _digest(torch, out) -> str:
    """sha256 of the bytes of a call's output tensors, in order."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if torch.is_tensor(t):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _front_case(torch, rnd, g, dev, R, d):
    """gps_front's forward and backward calls on seeded GPS-deep-sized
    inputs: ragged prefix node and edge masks, graph-local endpoints."""
    from graphgps_torch.ops.kernels import gps_front

    B, N, E, H = FRONT_GRAPHS, R // FRONT_GRAPHS, FRONT_EDGES, FRONT_HEADS
    idx = lambda: torch.randint(0, N, (B, E), generator=g,  # noqa: E731
                                device=dev, dtype=torch.int32)
    nodes = torch.randint(N // 4, N + 1, (B, 1), generator=g, device=dev)
    edges = torch.randint(E // 4, E + 1, (B, 1), generator=g, device=dev)
    nmask = (torch.arange(N, device=dev)[None] < nodes).float()
    emask = (torch.arange(E, device=dev)[None] < edges).float()
    w = lambda *s: rnd(*s, scale=s[0] ** -0.5)  # noqa: E731
    vec = lambda n=d: rnd(n, scale=0.1)  # noqa: E731
    args = (rnd(B, N, d), rnd(B, E, d), idx(), idx().sort(dim=1).values,
            emask, nmask, vec(), vec(), vec(), w(d, 7 * d), vec(7 * d),
            w(d, d), vec(), w(d, d), vec())
    conf = (SEED, H, 1.0 / float(d // H) ** 0.5, RATE, RATE)
    fwd = lambda: gps_front._launch_forward(args, *conf)  # noqa: E731
    outs, (proj, attn) = fwd()
    cots = [rnd(*o.shape) for o in outs]
    bwd = lambda: gps_front.gps_front_backward(  # noqa: E731
        *args, *conf, *cots, kept=(*outs[:3], proj, attn))
    return (lambda: fwd()[0]), bwd


def _run_one(root: str, kernels) -> None:
    """Time every kernel and shape with ``graphgps_torch`` from ``root``."""
    sys.path.insert(0, root)
    import torch

    from graphgps_torch.ops.kernels import bn_ffn, build, combine_ffn

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    build.build_all(kernels)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    for name in kernels:
        for tag, R, d in SHAPES[name]:
            dh = 2 * d
            vec = lambda: rnd(d, scale=0.1)  # noqa: E731
            pos = lambda: 1.0 + rnd(d, scale=0.1).abs()  # noqa: E731
            ffn_w = (rnd(d, dh, scale=d ** -0.5), vec().repeat(2),
                     rnd(dh, d, scale=dh ** -0.5), vec())
            if name == "gps_front":
                fwd, bwd = _front_case(torch, rnd, g, dev, R, d)
            elif name == "combine_ffn":
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
                bits = _digest(torch, fn())
                print(json.dumps(dict(root=root, kernel=f"{name}_{kind}",
                                      shape=tag, R=R, d=d, bits=bits,
                                      ms=_time(torch, fn))), flush=True)


def main(args) -> None:
    kernels = list(SHAPES)
    if args[0] == "--kernels":
        kernels, args = args[1].split(","), args[2:]
    roots = args
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--one", root,
                              ",".join(kernels)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"kernel_ab: {root} failed:\n"
                             f"{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    first, last = roots[0], [r for r in roots if r != roots[0]][-1]
    for key in sorted({(r["kernel"], r["shape"]) for r in rows}):
        runs = [r for r in rows if (r["kernel"], r["shape"]) == key]
        mean = {root: sum(r["ms"] for r in runs if r["root"] == root)
                / roots.count(root) for root in dict.fromkeys(roots)}
        print(json.dumps(dict(kernel=key[0], shape=key[1], mean_ms=mean,
                              ratio=mean[last] / mean[first],
                              same_bits=len({r["bits"] for r in runs}) == 1,
                              card=smi)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        _run_one(sys.argv[2], sys.argv[3].split(","))
    elif len(sys.argv) >= 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
