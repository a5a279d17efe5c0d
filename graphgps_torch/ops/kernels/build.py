"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The build runs at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the sources and
flags; ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gps_front", "pre_tail", "combine_ffn", "gatedgcn", "drop_add",
           "edge_gate", "wide_attention", "ln_ffn", "bn_ffn", "ffn",
           "gps_attention", "flash_mha", "segment_sum", "bigbird")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# activation codes of csrc/common.cuh
ACTS = {"identity": 0, "relu": 1, "gelu": 2}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The ``nvcc`` output (with ptxas' register and spill report) kept
    beside the library."""
    return _lib_path(name).with_suffix(".log")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.
    Returns seconds per built library; raises with the compiler's output if
    one fails. Each ``nvcc`` log is kept beside its library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out, time.perf_counter())
    except BaseException:
        for proc, *_ in procs.values():
            proc.kill()
            proc.wait()
        raise
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


_cfuncs: Dict[tuple, object] = {}


def cfunc(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library with its
    argument and result types set, once."""
    fn = _cfuncs.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _cfuncs[(name, symbol)] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require(name: str, t, shape, device, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` (and dtype,
    default float32) on ``device`` -- what the C kernels take."""
    dtype = dtype or torch.float32
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class _SeedPtr(ctypes.c_void_p):
    """A pointer argument that holds the tensor it points into."""


def seed_arg(seed, t: int, device) -> ctypes.c_void_p:
    """A dropout seed as the C entries take it, a pointer to a 32-bit word on
    ``device``: into ``seed``, a one-element int32 tensor there (an element
    of a training step's seed tensor, ``models/gps_layer.py`` ``StepSeeds``,
    or ``common.device_seed``'s: a CUDA graph that captures the launch reads
    whatever the word holds at each replay), or null when no site drops
    (``t`` = 0: the kernel reads no seed, and ``seed`` may be anything). The
    pointer holds the tensor for as long as the argument lives."""
    if t == 0:
        return _SeedPtr(None)
    if not torch.is_tensor(seed):
        raise TypeError(f"a dropout seed on {device} is a one-element int32 "
                        f"tensor there (common.device_seed), got {seed!r}")
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise ValueError(f"seed: a one-element int32 tensor, got "
                         f"{seed.dtype} of shape {tuple(seed.shape)}")
    if seed.device != device:
        raise ValueError(f"seed on {seed.device}, expected {device}")
    arg = _SeedPtr(seed.data_ptr())
    arg.tensor = seed
    return arg


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``. The C functions launch on the
    current device, so the tensors must live there."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
