#!/usr/bin/env python3
"""Device times and output bits of kernels of two checkouts, in turns, on
one GPU: the FFN-block kernels ``combine_ffn``, ``bn_ffn`` and ``ffn``, the
GatedGCN core ``gatedgcn``, the Graphormer MLP block ``ln_ffn``, the layer
front ``gps_front``, the GPS attention ``gps_attention``, the long-graph
attention ``flash_mha`` and ``wide_attention``, the long-graph edge gate
``edge_gate``, BigBird's block-sparse attention ``bigbird``, the edge tail
``pre_tail`` and the residual ``drop_add``, forward and backward, at the
shapes of ``chip_smoke.py`` phases 3, 3c, 3d, 3e, 3f, 3g, 3h, 3i and 3k and
of GPS-deep's layers with the front off (G'); and ``floor``, the card's
smallest launch (a one-element ``Tensor.add_``). Used to hold a change to a
shared body (``csrc/common.cuh``, ``csrc/ffn_core.cuh``,
``csrc/attn_tc.cuh``, ``csrc/gemm_tc.cuh``, ``csrc/tc_mma.cuh``) to its
parent's times and bits, and a redesigned kernel to its parent's times.

Usage, from anywhere, each ROOT a checkout holding ``graphgps_torch/``::

    python graphgps_torch/tools/kernel_ab.py [--kernels a,b] PARENT CHANGE CHANGE PARENT

Each ROOT runs in a process of its own that imports ``graphgps_torch`` from
ROOT and builds its kernels there (``ROOT/build/kernels``). Per kernel and
shape it prints one JSON line per run (device ms per call by
``torch.profiler`` over 50 calls after 5 warm-ups, seeded inputs, dropout
0.1 on every site, and a sha256 of the outputs' bytes), then one summary
line per kernel and shape: the mean ms of each ROOT, the ratio of the last
distinct ROOT to the first, whether every run gave the same bits, and the
card's name and power limit. Each run also carries its device ms and
launches per call by CUDA kernel name (``by_kernel``). The runs of the
attention kernels, ``gatedgcn`` and ``ln_ffn`` also carry the largest
difference from their plain versions on the same inputs (``max_abs_err``;
the summary gives each ROOT's largest), as do ``bigbird``'s, since a
redesign of their body changes the summation order and so the bits;
``pre_tail``'s and ``drop_add``'s carry it too, and their device ms with
the L2 cache flushed before each call (``cold_ms``: 64 MB written
between calls, the flush's kernels left out by name), and
``pre_tail_bwd``'s runs the digests of dv and of its four column sums apart
(``bits_dv``, ``bits_sums``; the summary says whether each is the same in
every run). Every run says whether a second call gave the first call's bits
(``rerun_same_bits``).
``edge_gate``'s calls walk the batch's edge orders built beforehand, where
ROOT has them (``edge_gate_orders``), and a row ``edge_gate_orders_fwd``
times building them (those ROOTs only). ``--kernels`` picks some of
``combine_ffn``, ``bn_ffn``, ``ffn``, ``gatedgcn``, ``ln_ffn``,
``gps_front``, ``gps_attention``, ``flash_mha``, ``wide_attention``,
``edge_gate``, ``bigbird``, ``pre_tail``, ``drop_add``, ``floor`` (by
default all). ``flash_mha``'s forward runs
also carry the largest distance in f32 ulps from its plain version
evaluated in f64 and rounded (``max_ulps_f64``). A run whose profile lost events (a kernel's launches
not a whole number a call) has ``profile_whole`` false; the summary's mean
leaves it out (unless all of a ROOT's runs lost events) and gives each
ROOT's count of such runs.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

# (tag, rows, width): phase 3's GPS-deep layer (batch 256 x 40 node
# slots, d 256), 3c's ogbg-molhiv (32 x 40, d 64) and pcqm4m-GPS (256 x
# 40, d 304), 3f's molhiv SAN (64 x 40, d 64) and the molpcba-SAN width
# (512 x 40, d 304), 3g's wn-squirrel (5,248 slots, d 96) and the actor
# width (7,680, d 64); gatedgcn (tag, B, N, E, d) at ogbg-molhiv's layer
# (32 graphs of 40 node and 96 edge slots, d 64), GPS-deep's with the front
# off (256 graphs, d 256) and pcqm4m-GPS's (d 304); gps_front at GPS-deep's
# layer (batch 256, 40 node slots, 96 edge slots, d 256, 8 heads); flash_mha
# (tag, B, N, H, Dh, with a bias, least real nodes) at 3i's VOC attention
# (400-500 real nodes of 512 slots, no dropout) and wn-squirrel's one graph
# (5,201 real of 5,248); wide_attention (tag, B, N, d, H, attention
# dropout) at 3d's VOC
# layer at the recipe's rate and at 0; gps_attention (tag, B, N, d, H,
# attention dropout) at 3h's GPS-deep layer (256 graphs of 40 slots, 8 heads
# of 32), at 64 graphs of 128 slots in 4 heads of 64 and at the pcqm4m-GPS
# width (d 304 in 4 heads of 76, rate 0.5); ln_ffn (tag, dropout inner,
# outer) on 3e's inputs (R 10,496 rows of d = dh = 80) at 0.1 / 0.1 and 0 / 0;
# edge_gate (tag, B, N, E, d) at 3d's VOC layer (32 graphs of 512 node and
# 1,024 edge slots, d 96) and at the real data's 3,072 edge slots a graph;
# bigbird (tag, B, H, N, Dh, least real nodes, plan seed) at 3k's
# wn-squirrel graph (5,201 real of 5,248 slots, 4 heads of 24, block 3, 3
# random blocks) with the plans of its three layers, and at 4 graphs of
# 2,048 slots (1,900-2,048 real); pre_tail (tag, rows, width, act) at the
# edge tails of GPS-deep's layer (256 graphs of 96 edge slots, d 256, gelu),
# ogbg-molhiv's (32 x 96, d 64, relu) and pcqm4m-GPS's (256 x 96, d 304,
# relu); drop_add (tag, rows, width) at ogbg-molhiv's attention branch
# (32 x 40 node slots, d 64), GPS-deep's with the front off (256 x 40, d
# 256), wn-squirrel's (5,248 slots, d 96) and pcqm4m-GPS's (256 x 40, d 304)
VOC_MIN_REAL = 400
SHAPES = {"combine_ffn": [("G", 10240, 256), ("M", 1280, 64),
                          ("P", 10240, 304)],
          "bn_ffn": [("S", 2560, 64), ("W", 20480, 304)],
          "ffn": [("Q", 5248, 96), ("A", 7680, 64)],
          "gatedgcn": [("M", 32, 40, 96, 64), ("G'", 256, 40, 96, 256),
                       ("P", 256, 40, 96, 304)],
          "ln_ffn": [("Z", 0.1, 0.1), ("Z0", 0.0, 0.0)],
          "gps_front": [("G", 10240, 256)],
          "gps_attention": [("G", 256, 40, 256, 8, 0.1),
                            ("E", 64, 128, 256, 4, 0.1),
                            ("P", 256, 40, 304, 4, 0.5)],
          "flash_mha": [("V'", 32, 512, 4, 24, False, VOC_MIN_REAL),
                        ("V'b", 32, 512, 4, 24, True, VOC_MIN_REAL),
                        ("Q'", 1, 5248, 4, 24, False, 5201)],
          "wide_attention": [("V", 32, 512, 96, 4, 0.5),
                             ("V0", 32, 512, 96, 4, 0.0)],
          "edge_gate": [("V", 32, 512, 1024, 96), ("V3", 32, 512, 3072, 96)],
          "bigbird": [("Q''0", 1, 4, 5248, 24, 5201, 0),
                      ("Q''1", 1, 4, 5248, 24, 5201, 1),
                      ("Q''2", 1, 4, 5248, 24, 5201, 2),
                      ("B4", 4, 4, 2048, 24, 1900, 0)],
          "pre_tail": [("G", 24576, 256, "gelu"), ("M", 3072, 64, "relu"),
                       ("P", 24576, 304, "relu")],
          "drop_add": [("M", 1280, 64), ("G'", 10240, 256), ("Q", 5248, 96),
                       ("P", 10240, 304)],
          "floor": [("1",)]}
# kernels timed also L2-cold, and the bytes written between those calls
COLD = ("pre_tail", "drop_add")
FLUSH_BYTES = 64 << 20
BIGBIRD_BLOCK, BIGBIRD_RANDOM = 3, 3
FRONT_GRAPHS, FRONT_NODES, FRONT_EDGES, FRONT_HEADS = 256, 40, 96, 8
ITERS, WARMUP, RATE, SEED = 50, 5, 0.1, 20260
# profiles of a call tried before giving up (one has recorded nothing)
PROFILE_TRIES = 3
# phase 3e's recipe and its model seed (chip_smoke.py ZINC_CFG, SEED)
ZINC_CFG, ZINC_SEED = "configs/Graphormer/zinc-Graphormer.yaml", 0


def _short(name: str) -> str:
    """A CUDA kernel's name without its arguments and namespaces."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("ggps::").strip()


def _profile(torch, body):
    """The CUDA kernels' events of ``body()`` under ``torch.profiler``, taken
    again when a profile recorded no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            body()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events
    raise SystemExit("kernel_ab: the profiler recorded no device time")


def _time(torch, fn, flush=None):
    """(Device ms per call of ``fn``, {kernel: [ms, launches] per call},
    whether every kernel's launches are a whole number a call): the CUDA
    kernels it launches, summed by ``torch.profiler`` over ITERS calls, so
    that the host's launch gaps (which decide a back-to-back timing at
    small shapes) do not count. With ``flush`` (a tensor larger than the L2
    cache) it is written before each call and its kernels are left out by
    name. The profiler has lost a call's events now and then (such a run
    reads low and says so), or recorded nothing (the profile is taken
    again)."""
    skip = set()
    if flush is not None:
        skip = {e.key for e in _profile(torch, lambda: [
            flush.fill_(0.0) for _ in range(ITERS)])}
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(ITERS):
            if flush is not None:
                flush.fill_(0.0)
            fn()

    for _ in range(PROFILE_TRIES):
        events = [e for e in _profile(torch, body) if e.key not in skip]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            break
    else:
        raise SystemExit("kernel_ab: the profiler recorded no device time")
    by_kernel = {}
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        ms, n = by_kernel.get(_short(e.key), (0.0, 0.0))
        by_kernel[_short(e.key)] = [ms + e.self_device_time_total / ITERS / 1e3,
                                    n + e.count / ITERS]
    whole = all(n == int(n) for _, n in by_kernel.values())
    return us / ITERS / 1e3, by_kernel, whole


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
    outs, kept = fwd()
    cots = [rnd(*o.shape) for o in outs]
    bwd = lambda: gps_front.gps_front_backward(  # noqa: E731
        *args, *conf, *cots, kept=(*outs[:3], *kept))
    return (lambda: fwd()[0]), bwd


def _voc_counts(torch, g, dev, B, N):
    """Real nodes per graph as 3d's and 3i's VOC batch holds them."""
    return torch.randint(VOC_MIN_REAL, 501, (B,), generator=g, device=dev,
                         dtype=torch.int32).clamp(max=N)


def _f32_ulps(torch, a, b):
    """|a - b| in f32 ulps (the port's ``flash_mha.f32_ulps``, kept here so
    that the tool runs on checkouts without it)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _flash_case(torch, rnd, g, dev, B, N, H, Dh, with_bias, min_real):
    """flash_mha's forward and backward calls, their plain versions and the
    forward's distance in f32 ulps from the plain forward in f64 rounded to
    f32, on seeded inputs (segment ids from ragged prefix masks of min_real
    to 500 real nodes, or min_real)."""
    import importlib

    # the package's ``flash_mha`` is the function; the module by its path
    fm = importlib.import_module("graphgps_torch.ops.kernels.flash_mha")
    counts = torch.randint(min_real, max(min_real, min(N, 500)) + 1, (B,),
                           generator=g, device=dev, dtype=torch.int32)
    mask = torch.arange(N, device=dev)[None] < counts[:, None]
    q, k, v = (rnd(B, H, N, Dh) for _ in range(3))
    bias = rnd(B, H, N, N) if with_bias else None
    ins = (q, k, v, mask, bias)
    o, kept = fm._launch_forward(*ins)
    cot = rnd(B, H, N, Dh)
    real = lambda out: tuple(t for t in out if t is not None)  # noqa: E731
    f64 = [None if t is None else t.double() for t in ins]
    f64[3] = mask
    return (lambda: fm._launch_forward(*ins)[0],
            lambda: real(fm.flash_mha_backward(*ins, o, cot, kept=kept)),
            lambda: fm.flash_mha_plain(*ins),
            lambda: real(fm.flash_mha_backward_plain(*ins, cot)),
            lambda out: _f32_ulps(torch, out,
                                  fm.flash_mha_plain(*f64).float()))


def _gatedgcn_case(torch, rnd, g, dev, B, N, E, d):
    """gatedgcn's forward and backward calls and their plain versions on
    seeded inputs: ragged prefix node and edge masks, graph-local
    endpoints."""
    from graphgps_torch.ops.kernels import gatedgcn

    idx = lambda: torch.randint(0, N, (B, E), generator=g,  # noqa: E731
                                device=dev, dtype=torch.int32)
    nodes = torch.randint(N // 4, N + 1, (B, 1), generator=g, device=dev)
    edges = torch.randint(E // 4, E + 1, (B, 1), generator=g, device=dev)
    nmask = (torch.arange(N, device=dev)[None] < nodes).float()
    emask = (torch.arange(E, device=dev)[None] < edges).float()
    w = lambda *s: rnd(*s, scale=s[0] ** -0.5)  # noqa: E731
    vec = lambda n=d: rnd(n, scale=0.1)  # noqa: E731
    args = (rnd(B, N, d), rnd(B, E, d), idx(), idx().sort(dim=1).values,
            emask, nmask, vec(), vec(), w(d, 4 * d), vec(4 * d), w(d, d),
            vec())
    outs, proj = gatedgcn._launch_forward(args)
    cots = [rnd(*o.shape) for o in outs]
    return (lambda: gatedgcn._launch_forward(args)[0],
            lambda: gatedgcn.gatedgcn_backward(
                *args, *cots, kept=(outs[0], outs[1], proj)),
            lambda: gatedgcn.gatedgcn_plain(*args),
            lambda: gatedgcn.gatedgcn_backward_plain(*args, *cots))


def _zinc_rows(root, dev):
    """Phase 3e's inputs by ``ln_ffn_inputs.py`` beside this file, loaded
    by its path (a parent checkout may predate it), on ``root``'s
    ``graphgps_torch`` and recipe."""
    spec = importlib.util.spec_from_file_location(
        "ln_ffn_inputs", Path(__file__).with_name("ln_ffn_inputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ln_ffn_inputs(os.path.join(root, ZINC_CFG),
                             ["seed", str(ZINC_SEED)], dev)[2]


def _ln_ffn_case(torch, rnd, ins, r1, r2):
    """ln_ffn's forward and backward calls and their plain versions on
    phase 3e's inputs ``ins`` at dropout r1 (inner) and r2 (outer)."""
    from graphgps_torch.ops.kernels import ln_ffn

    conf = (SEED, r1, r2, "gelu")
    out, kept = ln_ffn._launch_forward(ins, *conf, ln_ffn.EPS, True)
    cot = rnd(*out.shape)
    return (lambda: ln_ffn._launch_forward(ins, *conf, ln_ffn.EPS, False)[0],
            lambda: ln_ffn.ln_ffn_backward(*ins, cot, *conf, kept=kept),
            lambda: ln_ffn.ln_ffn_plain(*ins, *conf),
            lambda: ln_ffn.ln_ffn_backward_plain(*ins, cot, *conf))


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


def _gps_attention_case(torch, rnd, g, dev, B, N, d, H, rate):
    """gps_attention's forward and backward calls and their plain versions
    on seeded inputs: ragged prefix node masks (a quarter to all of N)."""
    from graphgps_torch.ops.kernels import gps_attention as ga

    w = lambda *s: rnd(*s, scale=s[0] ** -0.5)  # noqa: E731
    nodes = torch.randint(N // 4, N + 1, (B, 1), generator=g, device=dev)
    kmask = (torch.arange(N, device=dev)[None] < nodes).float()
    args = (rnd(B, N, d), kmask, w(d, 3 * d), rnd(3 * d, scale=0.1), w(d, d),
            rnd(d, scale=0.1))
    conf = (SEED, H, rate)
    y, kept = ga._launch_forward(args, *conf)
    cot = rnd(B, N, d)
    return (lambda: ga._launch_forward(args, *conf)[0],
            lambda: ga.gps_attention_backward(*args, *conf, cot, kept=kept),
            lambda: ga.gps_attention_plain(*args, *conf),
            lambda: ga.gps_attention_backward_plain(*args, *conf, cot))


def _edge_gate_case(torch, rnd, g, dev, B, N, E, d):
    """edge_gate's forward and backward calls, their plain versions and the
    call that builds the batch's edge orders (None on a ROOT without them)
    on seeded inputs laid out as the loader lays out a VOC batch: 400-500
    real nodes a graph, 85-100% of the edge slots real with random
    endpoints among them, receivers sorted per graph, and every padded edge
    slot masked on the graph's last real node (a hub). The kernel calls take
    the orders built beforehand, as a batch's layers share them."""
    from graphgps_torch.ops.kernels import edge_gate as eg

    nodes = _voc_counts(torch, g, dev, B, N).long()[:, None]
    real = torch.randint(int(0.85 * E), E + 1, (B, 1), generator=g,
                         device=dev)
    slot = torch.arange(E, device=dev)[None]
    ends = lambda: (torch.rand(B, E, generator=g, device=dev)  # noqa: E731
                    * nodes).long()
    emask = (slot < real).float()
    pad = lambda t: torch.where(slot < real, t, nodes - 1).int()  # noqa: E731
    r_loc = pad(ends().sort(dim=1).values)
    args = (rnd(B, N, d), rnd(B, N, 2 * d), rnd(B, E, d), pad(ends()), r_loc,
            emask)
    make = getattr(eg, "edge_gate_orders", None)
    orders = (lambda: make(args[3], args[4], N)) if make else None
    kw = dict(orders=orders()) if make else {}
    gate, nd = eg._launch_forward(args, *kw.values())
    cots = (rnd(B, E, d), rnd(B, N, 2 * d))
    return (lambda: eg._launch_forward(args, *kw.values()),
            lambda: eg.edge_gate_backward(*args, *cots, kept=(gate,), **kw),
            lambda: eg.edge_gate_plain(*args),
            lambda: eg.edge_gate_backward_plain(*args, *cots), orders)


def _bigbird_case(torch, rnd, g, dev, B, H, N, Dh, min_real, seed):
    """bigbird's forward and backward calls and their plain versions on
    seeded inputs: ragged prefix masks of min_real to N real nodes, the last
    graph's min_real (one graph) or all N (several)."""
    from graphgps_torch.ops.kernels import bigbird as kb

    counts = torch.randint(min_real, N + 1, (B,), generator=g, device=dev)
    counts[-1] = min_real if B == 1 else N
    mask = torch.arange(N, device=dev)[None] < counts[:, None]
    ins = (*(rnd(B, H, N, Dh) for _ in range(3)), mask, BIGBIRD_BLOCK,
           BIGBIRD_RANDOM, seed)
    o, kept = kb._launch_forward(*ins)
    cot = rnd(B, H, N, Dh)
    return (lambda: kb._launch_forward(*ins)[0],
            lambda: kb.bigbird_backward(*ins, o, cot, kept=kept),
            lambda: kb.bigbird_plain(*ins),
            lambda: kb.bigbird_backward_plain(*ins, cot))


def _tail_case(torch, rnd, name, R, d, act=None):
    """pre_tail's or drop_add's forward and backward calls and their plain
    versions on seeded inputs, dropout RATE (``act``: pre_tail's)."""
    from graphgps_torch.ops.kernels import drop_add, pre_tail

    x, v, cot = rnd(R, d), rnd(R, d), rnd(R, d)
    if name == "drop_add":
        conf = (SEED, RATE)
        return (lambda: drop_add._launch_forward(x, v, *conf),
                lambda: drop_add.drop_add_backward(cot, *conf),
                lambda: drop_add.drop_add_plain(x, v, *conf),
                lambda: drop_add.drop_add_backward_plain(cot, *conf))
    norm = (rnd(d), 0.5 + rnd(d).abs(), rnd(d), rnd(d, scale=0.1))
    conf = (SEED, RATE, act)
    return (lambda: pre_tail._launch_forward(x, v, *norm, *conf),
            lambda: pre_tail.pre_tail_backward(v, *norm, cot, *conf),
            lambda: pre_tail.pre_tail_plain(x, v, *norm, *conf),
            lambda: pre_tail.pre_tail_backward_plain(v, *norm, cot, *conf))


def _ffn_case(torch, rnd, name, R, d):
    """combine_ffn's, bn_ffn's or ffn's forward and backward calls on seeded
    inputs with dropout RATE on every site."""
    from graphgps_torch.ops.kernels import bn_ffn, combine_ffn, ffn

    dh = 2 * d
    vec = lambda: rnd(d, scale=0.1)  # noqa: E731
    pos = lambda: 1.0 + rnd(d, scale=0.1).abs()  # noqa: E731
    ffn_w = (rnd(d, dh, scale=d ** -0.5), vec().repeat(2),
             rnd(dh, d, scale=dh ** -0.5), vec())
    if name == "ffn":
        args = (rnd(R, d), *ffn_w)
        conf = (SEED, RATE, "relu", True)
        cot = rnd(R, d)
        return (lambda: ffn._launch_forward(args, *conf),
                lambda: ffn.ffn_backward(*args, cot, *conf))
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
    build.build_all([k for k in kernels if k in build.SOURCES])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    zinc = None
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for name in kernels:
        for tag, *shape in SHAPES[name]:
            plain, ulps, extra = (None, None), None, []
            if name == "floor":
                one = torch.zeros(1, device=dev)
                fwd, bwd = (lambda: one.add_(1.0)), None
            elif name in ("pre_tail", "drop_add"):
                fwd, bwd, *plain = _tail_case(torch, rnd, name, *shape)
            elif name == "gps_front":
                fwd, bwd = _front_case(torch, rnd, g, dev, *shape)
            elif name == "gatedgcn":
                fwd, bwd, *plain = _gatedgcn_case(torch, rnd, g, dev, *shape)
            elif name == "ln_ffn":
                zinc = zinc or _zinc_rows(root, dev)
                fwd, bwd, *plain = _ln_ffn_case(torch, rnd, zinc, *shape)
            elif name == "flash_mha":
                fwd, bwd, *plain, ulps = _flash_case(torch, rnd, g, dev,
                                                     *shape)
            elif name == "wide_attention":
                fwd, bwd, *plain = _wide_case(torch, rnd, g, dev, *shape)
            elif name == "gps_attention":
                fwd, bwd, *plain = _gps_attention_case(torch, rnd, g, dev,
                                                       *shape)
            elif name == "bigbird":
                fwd, bwd, *plain = _bigbird_case(torch, rnd, g, dev, *shape)
            elif name == "edge_gate":
                fwd, bwd, *plain, orders = _edge_gate_case(torch, rnd, g,
                                                           dev, *shape)
                if orders is not None:
                    extra = [("edge_gate_orders", "fwd", orders, None)]
            else:
                fwd, bwd = _ffn_case(torch, rnd, name, *shape)
            calls = [(name, "fwd", fwd, plain[0]),
                     (name, "bwd", bwd, plain[1]), *extra]
            for kname, kind, fn, ref in [c for c in calls if c[2]]:
                out = fn()
                if kname == "edge_gate_orders":
                    out = (out.perm, out.plan.ptr)
                row = dict(root=root, kernel=f"{kname}_{kind}", shape=tag,
                           dims=shape, bits=_digest(torch, out))
                if name != "floor" and kname != "edge_gate_orders":
                    row["rerun_same_bits"] = row["bits"] == _digest(torch,
                                                                    fn())
                if f"{kname}_{kind}" == "pre_tail_bwd":
                    row["bits_dv"] = _digest(torch, out[0])
                    row["bits_sums"] = _digest(torch, out[1:])
                if ref is not None:
                    row["max_abs_err"], row["max_err_over_tensor_max"] = \
                        _errors(torch, out, ref())
                if kind == "fwd" and ulps is not None:
                    row["max_ulps_f64"] = int(ulps(out).max())
                row["ms"], row["by_kernel"], row["profile_whole"] = \
                    _time(torch, fn)
                if name in COLD:
                    row["cold_ms"] = _time(torch, fn, flush)[0]
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
    first = roots[0]
    last = ([r for r in roots if r != first] or [first])[-1]
    for key in sorted({(r["kernel"], r["shape"]) for r in rows}):
        runs = [r for r in rows if (r["kernel"], r["shape"]) == key]
        # a run whose profile lost events reads low: a ROOT's mean leaves
        # it out while the ROOT has a whole one
        # the ROOTs with runs of this kernel (edge_gate_orders: those that
        # build orders)
        have = [root for root in dict.fromkeys(roots)
                if any(r["root"] == root for r in runs)]
        mean = {}
        for root in have:
            mine = [r for r in runs if r["root"] == root]
            mine = [r for r in mine if r["profile_whole"]] or mine
            mean[root] = sum(r["ms"] for r in mine) / len(mine)
        extra = {}
        for err in ("max_abs_err", "max_err_over_tensor_max",
                    "max_ulps_f64"):
            if err in runs[0]:
                extra[err] = {root: max(r[err] for r in runs
                                        if r["root"] == root)
                              for root in have}
        lost = {root: sum(not r["profile_whole"] for r in runs
                          if r["root"] == root) for root in have}
        if any(lost.values()):
            extra["profiles_lost_events"] = lost
        ratio = (mean[last] / mean[first] if first in mean and last in mean
                 else None)
        for part in ("bits_dv", "bits_sums"):
            if part in runs[0]:
                extra[f"same_{part}"] = len({r[part] for r in runs}) == 1
        if "cold_ms" in runs[0]:
            extra["mean_cold_ms"] = {
                root: sum(r["cold_ms"] for r in runs if r["root"] == root)
                / sum(r["root"] == root for r in runs) for root in have}
        print(json.dumps(dict(kernel=key[0], shape=key[1], mean_ms=mean,
                              ratio=ratio,
                              same_bits=len({r["bits"] for r in runs}) == 1,
                              card=smi, **extra)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        _run_one(sys.argv[2], sys.argv[3].split(","))
    elif len(sys.argv) >= 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
