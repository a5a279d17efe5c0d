#!/usr/bin/env python3
"""Device times of the segment sums (``csrc/segment_sum.cu`` behind
``segment_sum_csr`` and ``tiled_segment_sum``) over the edges a warp task
holds at most (the plan's ``task_len``), on one GPU, at the shapes of
``chip_smoke.py`` phase 3j on seeded inputs, beside ``Tensor.index_add`` on
the same inputs. Used to choose ``TASK_LEN`` in
``graphgps_torch/ops/kernels/segment_sum.py``.

Usage, from the repository root on a machine with a CUDA device::

    python graphgps_torch/tools/segment_sweep.py

(the repository root goes on the import path)
Per case, task length and wrapper it prints one JSON line: device ms per
call of the sum kernel alone (``torch.profiler`` over 50 calls after 5
warm-ups, the plan built beforehand), of the plan, and the largest
difference from the plain version; then the card's name and power limit
and the ptxas report (registers, spills) of the kernel's library."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

ITERS, WARMUP, SEED, TRIES = 50, 5, 0, 3
TASK_LENS = (32, 64, 128, 256)
# (tag, E, S, d, kind): wn-squirrel's aggregation (uniform ids but a
# 133-edge segment, as its padded edges make), with power-law hubs, with
# every edge in one segment, MalNet's size uniform and with hubs
CASES = [("Q", 41600, 5248, 96, "q"), ("H", 41600, 5248, 96, "hubs"),
         ("one", 41600, 5248, 96, "one"), ("N", 313000, 80000, 64, "uniform"),
         ("NH", 313000, 80000, 64, "hubs")]


def _time(torch, fn, name=None) -> float:
    """Device ms per call of ``fn``: its CUDA kernels (those whose name
    holds ``name``, where given) summed by ``torch.profiler`` over ITERS
    calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRIES):   # a profile now and then comes back empty
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (name is None or name in e.key))
        if us > 0:
            return us / ITERS / 1e3
    raise SystemExit("segment_sweep: the profiler recorded no device time")


def _ids(torch, E: int, S: int, kind: str, g):
    dev = torch.device("cuda", 0)
    if kind == "one":
        return torch.full((E,), S // 2, device=dev, dtype=torch.int32)
    if kind == "hubs":
        p = 1.0 / torch.arange(1, S + 1, device=dev, dtype=torch.float64)
        return torch.multinomial(p / p.sum(), E, replacement=True,
                                 generator=g).to(torch.int32)
    ids = torch.randint(0, S, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "q":
        ids[-133:] = S - 48
    return ids


def main() -> None:
    import torch

    from graphgps_torch.ops.kernels import build
    from graphgps_torch.ops.kernels import segment_sum as ks

    if not torch.cuda.is_available():
        raise SystemExit("segment_sweep: needs a CUDA device")
    build.build_all(["segment_sum"])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for tag, E, S, d, kind in CASES:
        ids = _ids(torch, E, S, kind, g)
        data = torch.randn(E, d, generator=g, device="cuda")
        sids, order = torch.sort(ids, stable=True)
        sdata = data[order].contiguous()
        zeros = torch.zeros(S, d, device="cuda")
        lib = {"segment_csr": _time(
                   torch, lambda: zeros.index_add(0, sids.long(), sdata)),
               "segment_tiled": _time(
                   torch, lambda: zeros.index_add(0, ids.long(), data))}
        want = {"segment_csr": ks.segment_sum_csr_plain(
                    sdata, sids, ks.row_ptr_from_sorted(sids, S), S),
                "segment_tiled": ks.tiled_segment_sum_plain(data, ids, S)}
        for task_len in TASK_LENS:
            plans = {
                "segment_csr": ks.segment_plan(sids, S, False, task_len),
                "segment_tiled": ks.segment_plan(ids, S, True, task_len)}
            calls = {
                "segment_csr": lambda p: ks.segment_sum_csr(
                    sdata, sids, None, S, plan=p),
                "segment_tiled": lambda p: ks.tiled_segment_sum(
                    data, ids, S, plan=p)}
            plan_ms = {
                "segment_csr": _time(torch, lambda: ks.segment_plan(
                    sids, S, False, task_len)),
                "segment_tiled": _time(torch, lambda: ks.segment_plan(
                    ids, S, True, task_len))}
            for name, plan in plans.items():
                got = calls[name](plan)
                err = float((got - want[name]).abs().max())
                ms = _time(torch, lambda: calls[name](plan),
                           "segment_sum_kernel")
                print(json.dumps(dict(
                    case=tag, E=E, S=S, d=d, name=name, task_len=task_len,
                    ms=ms, plan_ms=plan_ms[name], library_ms=lib[name],
                    max_abs_err=err,
                    largest_segment=int(torch.bincount(ids.long()).max()))),
                    flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for line in build.log_path("segment_sum").read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("ptxas:", line.strip(), flush=True)


if __name__ == "__main__":
    main()
