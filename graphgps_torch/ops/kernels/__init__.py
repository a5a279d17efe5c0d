"""The hand-written CUDA kernels of the ported paths, one wrapper each:
fifteen forward kernels (two of them, the segment sums, behind one source),
thirteen backward kernels, and the segment sums' plan kernel.

Every wrapper keeps a launch count (``wrapper.launches``), raised by one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels. A CUDA graph capture calls each wrapper of
the captured step once, and those calls count once; its replays run no
Python and are counted apart (:func:`note_replay`, :func:`graph_replays`):
a replay launches what its capture counted.
"""
from .bigbird import bigbird_backward, bigbird_block_sparse
from .bn_ffn import bn_ffn_backward, fused_bn_ffn
from .combine_ffn import combine_ffn_backward, fused_combine_ffn
from .drop_add import drop_add_backward, fused_drop_add
from .edge_gate import edge_gate_backward, fused_edge_gate
from .ffn import ffn_backward, fused_ffn
from .flash_mha import flash_mha, flash_mha_backward
from .gps_attention import fused_gps_attention, gps_attention_backward
from .gatedgcn import fused_gatedgcn, gatedgcn_backward
from .gps_front import fused_gps_front, gps_front_backward
from .ln_ffn import fused_ln_ffn, ln_ffn_backward
from .pre_tail import fused_pre_tail, pre_tail_backward
from .segment_sum import segment_plan, segment_sum_csr, tiled_segment_sum
from .wide_attention import fused_wide_attention, wide_attention_backward

WRAPPERS = {"gps_front": fused_gps_front, "pre_tail": fused_pre_tail,
            "combine_ffn": fused_combine_ffn,
            "gps_front_bwd": gps_front_backward,
            "pre_tail_bwd": pre_tail_backward,
            "combine_ffn_bwd": combine_ffn_backward,
            "gatedgcn": fused_gatedgcn, "gatedgcn_bwd": gatedgcn_backward,
            "drop_add": fused_drop_add, "drop_add_bwd": drop_add_backward,
            "edge_gate": fused_edge_gate, "edge_gate_bwd": edge_gate_backward,
            "wide_attention": fused_wide_attention,
            "wide_attention_bwd": wide_attention_backward,
            "ln_ffn": fused_ln_ffn, "ln_ffn_bwd": ln_ffn_backward,
            "bn_ffn": fused_bn_ffn, "bn_ffn_bwd": bn_ffn_backward,
            "ffn": fused_ffn, "ffn_bwd": ffn_backward,
            "gps_attention": fused_gps_attention,
            "gps_attention_bwd": gps_attention_backward,
            "flash_mha": flash_mha, "flash_mha_bwd": flash_mha_backward,
            "segment_csr": segment_sum_csr, "segment_tiled": tiled_segment_sum,
            "segment_plan": segment_plan,
            "bigbird": bigbird_block_sparse, "bigbird_bwd": bigbird_backward}


_replays = 0


def reset_launch_counts() -> None:
    """Every wrapper's count and the replay count to 0."""
    global _replays
    for fn in WRAPPERS.values():
        fn.launches = 0
    _replays = 0


def launch_counts() -> dict:
    """Wrapper calls by name: eager launches and captured ones."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def note_replay(n: int = 1) -> None:
    """Count ``n`` replays of a captured CUDA graph."""
    global _replays
    _replays += n


def graph_replays() -> int:
    """Replays of captured CUDA graphs since the counts were reset."""
    return _replays
