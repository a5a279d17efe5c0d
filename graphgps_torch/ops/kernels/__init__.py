"""The hand-written CUDA kernels of the main path, one wrapper each.

Every wrapper keeps a launch count (``wrapper.launches``), raised by one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.
"""
from .combine_ffn import fused_combine_ffn
from .gps_front import fused_gps_front
from .pre_tail import fused_pre_tail

WRAPPERS = {"gps_front": fused_gps_front, "pre_tail": fused_pre_tail,
            "combine_ffn": fused_combine_ffn}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
