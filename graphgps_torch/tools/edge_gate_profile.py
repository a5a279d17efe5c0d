#!/usr/bin/env python3
"""Where the time of a checkout's edge-gate kernels goes, on one GPU.

Usage, from anywhere (ROOT a checkout holding ``graphgps_torch/``, for
example the parent unpacked under ``build/parent``)::

    python graphgps_torch/tools/edge_gate_profile.py ROOT

Builds ``ROOT/graphgps_torch/csrc/edge_gate.cu`` twice into
``ROOT/build/edge_gate_profile/``: as it is, and with every loop over the
edges emptied (``j0 < E`` made ``j0 < 0``: what is left is a block's set-up,
its shared-memory zeroing and its write-out). Calls both through their C
entries, forward and backward, at VOC's 32 graphs of 512 node slots, d = 96,
on seeded inputs with E = 1,024, 2,048, 3,072 and 6,144 edge slots a graph
(random senders, receivers sorted per graph, 9 in 10 edge slots real), and
prints one JSON line per kernel, variant and E with its device ms (CUDA
events over 50 calls after 5 warm-ups), then the card's name and power
limit. For the shared-memory kernel of ``edge_gate.cu`` before the edge
orders (its C entries take no orders)."""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

B, N, D = 32, 512, 96
EDGES = (1024, 2048, 3072, 6144)
ITERS, WARMUP, SEED = 50, 5, 20260
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def _build(root: Path, out: Path) -> dict:
    """{variant: the loaded library}: the source as it is ("full") and with
    its edge loops emptied ("no_edges")."""
    csrc = root / "graphgps_torch" / "csrc"
    src = (csrc / "edge_gate.cu").read_text()
    emptied, n = re.subn(r"j0 < E;", "j0 < 0;", src)
    if n == 0:
        raise SystemExit("edge_gate_profile: no edge loop `j0 < E` in "
                         f"{csrc / 'edge_gate.cu'}")
    out.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    libs = {}
    for name, text in (("full", src), ("no_edges", emptied)):
        cu = out / f"edge_gate_{name}.cu"
        cu.write_text(text)
        so = out / f"libedge_gate_{name}.so"
        subprocess.run([nvcc, *FLAGS, "-I", str(csrc), "-o", str(so),
                        str(cu)], check=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _time(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main(root: str) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("edge_gate_profile: no CUDA device")
    root = Path(root).resolve()
    libs = _build(root, root / "build" / "edge_gate_profile")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ints = [ctypes.c_int] * 4
    for lib in libs.values():
        lib.edge_gate_forward.argtypes = [ctypes.c_void_p] * 8 + ints + [
            ctypes.c_void_p]
        lib.edge_gate_backward.argtypes = [ctypes.c_void_p] * 10 + ints + [
            ctypes.c_void_p]
        for fn in (lib.edge_gate_forward, lib.edge_gate_backward):
            fn.restype = ctypes.c_int
    for E in EDGES:
        idx = lambda: torch.randint(0, N, (B, E), generator=g,  # noqa: E731
                                    device=dev, dtype=torch.int32)
        pd, peb, ce = rnd(B, N, D), rnd(B, N, 2 * D), rnd(B, E, D)
        s, r = idx(), idx().sort(dim=1).values
        em = (torch.rand(B, E, generator=g, device=dev) < 0.9).float()
        gate, nd = torch.empty(B, E, D, device=dev), torch.empty(
            B, N, 2 * D, device=dev)
        gg, gnd = rnd(B, E, D), rnd(B, N, 2 * D)
        dpd, dpeb, dce = (torch.empty_like(t) for t in (pd, peb, ce))
        for name, lib in libs.items():
            fwd = lambda: lib.edge_gate_forward(  # noqa: E731
                *map(p, (pd, peb, ce, s, r, em, gate, nd)), B, N, E, D,
                stream)
            if fwd() != 0:
                raise SystemExit(f"edge_gate_profile: {name} forward failed")
            bwd = lambda: lib.edge_gate_backward(  # noqa: E731
                *map(p, (peb, gate, s, r, em, gg, gnd, dpd, dpeb, dce)), B,
                N, E, D, stream)
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                print(json.dumps(dict(kernel=f"edge_gate_{kind}",
                                      variant=name, B=B, N=N, E=E, d=D,
                                      ms=_time(torch, fn))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=smi, root=str(root))), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
