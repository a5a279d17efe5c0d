#!/usr/bin/env python3
"""Device times and output bits of kernels of two checkouts, in turns, on
one GPU: the FFN-block kernels ``combine_ffn`` and ``bn_ffn``, the layer
front ``gps_front`` and the long-graph attention ``flash_mha`` and
``wide_attention``, forward and backward, at the shapes of
``chip_smoke.py`` phases 3, 3c, 3d, 3f and 3i. Used to hold a change to a
shared body (``csrc/ffn_core.cuh``, ``csrc/mha_core.cuh``,
``csrc/attn_tc.cuh``) to its parent's times and bits.

Usage, from anywhere, each ROOT a checkout holding ``graphgps_torch/``::

    python graphgps_torch/tools/kernel_ab.py [--kernels a,b] PARENT CHANGE CHANGE PARENT

Each ROOT runs in a process of its own that imports ``graphgps_torch`` from
ROOT and builds its kernels there (``ROOT/build/kernels``). Per kernel and
shape it prints one JSON line per run (device ms per call by
``torch.profiler`` over 50 calls after 5 warm-ups, seeded inputs, dropout
0.1 on every site, and a sha256 of the outputs' bytes), then one summary
line per kernel and shape: the mean ms of each ROOT, the ratio of the last
distinct ROOT to the first, whether every run gave the same bits, and the
card's name and power limit. The attention kernels' runs also carry the
largest difference from their plain versions on the same inputs
(``max_abs_err``; the summary gives each ROOT's largest), since a redesign
of their body changes the summation order and so the bits. ``--kernels``
picks some of ``combine_ffn``, ``bn_ffn``, ``gps_front``, ``flash_mha``,
``wide_attention`` (by default all).
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
# slots, 96 edge slots, d 256, 8 heads); flash_mha (tag, B, N, H, Dh, with
# a bias) at 3i's VOC attention (400-500 real nodes of 512 slots, no
# dropout); wide_attention (tag, B, N, d, H, attention dropout) at 3d's VOC
# layer at the recipe's rate and at 0
SHAPES = {"combine_ffn": [("G", 10240, 256), ("M", 1280, 64),
                          ("P", 10240, 304)],
          "bn_ffn": [("S", 2560, 64), ("W", 20480, 304)],
          "gps_front": [("G", 10240, 256)],
          "flash_mha": [("V'", 32, 512, 4, 24, False),
                        ("V'b", 32, 512, 4, 24, True)],
          "wide_attention": [("V", 32, 512, 96, 4, 0.5),
                             ("V0", 32, 512, 96, 4, 0.0)]}
FRONT_GRAPHS, FRONT_NODES, FRONT_EDGES, FRONT_HEADS = 256, 40, 96, 8
VOC_MIN_REAL = 400
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


def _voc_counts(torch, g, dev, B, N):
    """Real nodes per graph as 3d's and 3i's VOC batch holds them."""
    return torch.randint(VOC_MIN_REAL, 501, (B,), generator=g, device=dev,
                         dtype=torch.int32).clamp(max=N)


def _flash_case(torch, rnd, g, dev, B, N, H, Dh, with_bias):
    """flash_mha's forward and backward calls and their plain versions on
    seeded VOC-sized inputs (segment ids from ragged prefix masks)."""
    import importlib

    # the package's ``flash_mha`` is the function; the module by its path
    fm = importlib.import_module("graphgps_torch.ops.kernels.flash_mha")
    counts = _voc_counts(torch, g, dev, B, N)
    mask = torch.arange(N, device=dev)[None] < counts[:, None]
    q, k, v = (rnd(B, H, N, Dh) for _ in range(3))
    bias = rnd(B, H, N, N) if with_bias else None
    ins = (q, k, v, mask, bias)
    o, kept = fm._launch_forward(*ins)
    cot = rnd(B, H, N, Dh)
    real = lambda out: tuple(t for t in out if t is not None)  # noqa: E731
    return (lambda: fm._launch_forward(*ins)[0],
            lambda: real(fm.flash_mha_backward(*ins, o, cot, kept=kept)),
            lambda: fm.flash_mha_plain(*ins),
            lambda: real(fm.flash_mha_backward_plain(*ins, cot)))


def _wide_case(torch, rnd, g, dev, B, N, d, H, rate):
    """wide_attention's forward and backward calls and their plain
    versions on seeded VOC-sized inputs."""
    from graphgps_torch.ops.kernels import wide_attention as wa

    w = lambda *s: rnd(*s, scale=s[0] ** -0.5)  # noqa: E731
    args = (rnd(B, N, d), _voc_counts(torch, g, dev, B, N), w(d, 3 * d),
            rnd(3 * d, scale=0.1), w(d, d), rnd(d, scale=0.1))
    conf = (SEED, H, 1.0 / float(d // H) ** 0.5, rate)
    y, kept = wa._launch_forward(args, *conf)
    cot = rnd(B, N, d)
    return (lambda: wa._launch_forward(args, *conf)[0],
            lambda: wa.wide_attention_backward(*args, *conf, cot, kept=kept),
            lambda: wa.wide_attention_plain(*args, *conf),
            lambda: wa.wide_attention_backward_plain(*args, *conf, cot))


def _ffn_case(torch, rnd, name, R, d):
    """combine_ffn's or bn_ffn's forward and backward calls on seeded
    inputs with dropout RATE on every site."""
    from graphgps_torch.ops.kernels import bn_ffn, combine_ffn

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
        return fwd, lambda: combine_ffn.combine_ffn_backward(
            *args, cot, *conf, kept=(h, a1, z))
    args = (rnd(R, d), vec(), pos(), pos(), vec(), *ffn_w)
    conf = (SEED, RATE, "relu", True)
    fwd = lambda: bn_ffn._launch_forward(args, *conf, True)  # noqa: E731
    out, kept = fwd()
    cot = rnd(R, d)
    return fwd, lambda: bn_ffn.bn_ffn_backward(*args, cot, *conf, kept=kept)


def _errors(torch, got, want):
    """(The largest elementwise difference over a call's output tensors,
    the largest over a tensor's largest entry, as ``chip_smoke.py`` holds
    them.)"""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    errs = [(float((a - b).abs().max()), float(b.abs().max()))
            for a, b in zip(got, want)]
    return (max(e for e, _ in errs),
            max(e / m if m > 0 else e for e, m in errs))


def _run_one(root: str, kernels) -> None:
    """Time every kernel and shape with ``graphgps_torch`` from ``root``."""
    sys.path.insert(0, root)
    import torch

    from graphgps_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    build.build_all(kernels)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    for name in kernels:
        for tag, *shape in SHAPES[name]:
            plain = (None, None)
            if name == "gps_front":
                fwd, bwd = _front_case(torch, rnd, g, dev, *shape)
            elif name == "flash_mha":
                fwd, bwd, *plain = _flash_case(torch, rnd, g, dev, *shape)
            elif name == "wide_attention":
                fwd, bwd, *plain = _wide_case(torch, rnd, g, dev, *shape)
            else:
                fwd, bwd = _ffn_case(torch, rnd, name, *shape)
            for kind, fn, ref in (("fwd", fwd, plain[0]),
                                  ("bwd", bwd, plain[1])):
                out = fn()
                row = dict(root=root, kernel=f"{name}_{kind}", shape=tag,
                           dims=shape, bits=_digest(torch, out))
                if ref is not None:
                    row["max_abs_err"], row["max_err_over_tensor_max"] = \
                        _errors(torch, out, ref())
                row["ms"] = _time(torch, fn)
                print(json.dumps(row), flush=True)


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
        extra = {}
        for err in ("max_abs_err", "max_err_over_tensor_max"):
            if err in runs[0]:
                extra[err] = {root: max(r[err] for r in runs
                                        if r["root"] == root)
                              for root in dict.fromkeys(roots)}
        print(json.dumps(dict(kernel=key[0], shape=key[1], mean_ms=mean,
                              ratio=mean[last] / mean[first],
                              same_bits=len({r["bits"] for r in runs}) == 1,
                              card=smi, **extra)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        _run_one(sys.argv[2], sys.argv[3].split(","))
    elif len(sys.argv) >= 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
