"""The fused FFN route's width rule, shared by ``bn_ffn`` and ``ffn`` (the
C side's ``csrc/ffn_fused.cuh`` ``FfnLayout`` and ``fused::fits``): where W1,
W2 and a block of ``FUSED_ROWS`` rows fit in a block's shared memory, one
fused launch forward and one plus a fixed-order reduce backward; wider FFNs
run a launch sequence over the tensor-core GEMM."""
from __future__ import annotations

# rows a block, the bytes a block may take (the H100's 227 KB)
FUSED_ROWS = 16
FUSED_SMEM_LIMIT = 232448


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _ld(n: int, r: int) -> int:
    """The least stride >= n that is r mod 32 (``ld4``/``ld8``)."""
    return n + (r - n % 32) % 32


def fused_smem(d: int, dh: int, backward: bool) -> int:
    """Bytes of shared memory ``FfnLayout`` lays out at widths d and dh: W1
    and W2, and a block's row tiles (h and z forward; h, z, da2, da1 and dh
    backward), each row at a stride that spreads a tensor-core fragment's
    reads over the 32 banks."""
    dp, dhp, R = _pad16(d), _pad16(dh), FUSED_ROWS
    if backward:
        floats = (dp * _ld(dhp, 4) + dhp * _ld(dp, 4)
                  + R * (_ld(dp, 8) + _ld(dhp, 8) + 2 * _ld(dp, 4)
                         + _ld(dhp, 4)))
    else:
        floats = (dp * _ld(dhp, 8) + dhp * _ld(dp, 8)
                  + R * (_ld(dp, 4) + _ld(dhp, 4)))
    return 4 * floats


def takes_fused(d: int, dh: int) -> bool:
    """Whether widths (d, dh) take the fused route: both ways' blocks fit in
    FUSED_SMEM_LIMIT bytes."""
    return max(fused_smem(d, dh, False),
               fused_smem(d, dh, True)) <= FUSED_SMEM_LIMIT
