#!/usr/bin/env python3
"""Which f64 ``mma.sync`` shapes (DMMA) the CUDA toolkit builds for
``sm_90a``, and the rate of each on the card: the choice behind
``csrc/tc_mma.cuh``'s ``dmma`` (flash_mha's forward).

Usage, from the repository root on a machine with the card::

    python graphgps_torch/tools/dmma_probe.py

Builds one small program per shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16)
with ``nvcc`` into ``build/dmma_probe/``, all at once, and runs each: 132 x 8
blocks of 4 warps, each warp 4 independent chains of 4,096 products, timed
by CUDA events. Prints one JSON line per shape (TFLOP/s, or the compiler's
refusal) and the card's name and power limit."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[2] / "build" / "dmma_probe"
# shape: (M, K, A registers, B registers, C registers)
SHAPES = {"m8n8k4": (8, 4, 1, 1, 2), "m16n8k4": (16, 4, 2, 1, 4),
          "m16n8k8": (16, 8, 4, 2, 4), "m16n8k16": (16, 16, 8, 4, 4)}
SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void rate(double* out, int iters) {
  double a[NA], b[NB], d[4][NC];
  for (int i = 0; i < NA; ++i) a[i] = 1.0 + 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < NB; ++i) b[i] = 1.0 - 1e-3 * (threadIdx.x + i);
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < NC; ++i) d[c][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile(INSTR OPERANDS);
  double s = 0.0;
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < NC; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  const int blocks = 132 * 8, threads = 128, iters = 4096;
  double* out;
  cudaMalloc(&out, sizeof(double) * blocks * threads);
  rate<<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * M * 8 * K * 4.0 * iters * blocks * (threads / 32);
  printf("%f %f %s\n", ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def _source(M, K, na, nb, nc) -> str:
    """The program of one shape: its instruction and operand list defined
    ahead of SOURCE."""
    regs = lambda n, o: ", ".join(f"%{o + i}" for i in range(n))  # noqa: E731
    instr = (f"mma.sync.aligned.m{M}n8k{K}.row.col.f64.f64.f64.f64 "
             f"{{{regs(nc, 0)}}}, {{{regs(na, nc)}}}, {{{regs(nb, nc + na)}}},"
             f" {{{regs(nc, 0)}}};")
    outs = ", ".join(f'"+d"(d[c][{i}])' for i in range(nc))
    ins = ", ".join([f'"d"(a[{i}])' for i in range(na)]
                    + [f'"d"(b[{i}])' for i in range(nb)])
    return "".join(f"#define {k} {v}\n" for k, v in (
        ("M", M), ("K", K), ("NA", na), ("NB", nb), ("NC", nc),
        ("INSTR", f'"{instr}"'), ("OPERANDS", f": {outs} : {ins}"))) + SOURCE


def main() -> None:
    from graphgps_torch.ops.kernels.build import nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, shape in SHAPES.items():
        src = OUT / f"{name}.cu"
        src.write_text(_source(*shape))
        procs[name] = subprocess.Popen(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
             str(OUT / name), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps(dict(shape=name, built=False,
                                  nvcc=log.strip()[-500:])), flush=True)
            continue
        ms, tflops, err = subprocess.run(
            [str(OUT / name)], capture_output=True, text=True,
            check=True).stdout.split(maxsplit=2)
        print(json.dumps(dict(shape=name, built=True, ms=float(ms),
                              tflops=float(tflops), cuda=err.strip())),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
