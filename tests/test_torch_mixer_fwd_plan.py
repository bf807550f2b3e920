"""The float32 mixer forward's workspace (K1f/K2f, ``csrc/mixer_fwd.cu``).

The wrapper sizes its workspace with ``m2m_mixer_fwd_workspace_bytes``. That
C function runs only where the kernels are built, so here it is mirrored in
Python (``fwd_workspace_floats``, the arithmetic of ``make_fwd_plan`` and of
``tile_common.cuh``'s slice planner) behind a fake library, and the wrapper
is held to the mirror's byte counts at the B config's shapes, pinned below.
``tests/test_torch_cuda_kernels.py`` holds the real function to the same
mirror on the card.
"""

import pytest

from m2mixer_tpu_torch.ops import mixer_kernel as mk

SMS = 132  # an H100 SXM
TC_BM, TC_BN, TC_K, MAX_SPLIT = 128, 64, 32, 32  # kTcBM, kTcBN, kTcK, kMaxSplit
MAX_TOKENS, MAX_BLOCKS = 32, 32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fill_slices(depth: int, tiles: int, sms: int):
    """(slice, split) of tile_common.cuh::fill_slices: slices of whole kTcK
    stages for two CTAs an SM, at most kMaxSplit."""
    n = min(2 * sms // tiles, MAX_SPLIT)
    size = cdiv(cdiv(depth, max(n, 1)), TC_K) * TC_K
    return size, cdiv(depth, size)


def fwd_workspace_floats(B, N, T, D, C, n_blocks, sms=SMS):
    """make_fwd_plan's workspace in floats, or 0 for shapes the kernels do
    not take (check_f32): padded W3 copies where C % 4, x1, z, h2 (rows x
    Cp) and the down product's slices of C (ksplit x rows x D), each
    rounded up to whole 16-byte groups."""
    if not (B >= 1 and 1 <= N <= MAX_TOKENS and T >= 1 and D >= 4 and D % 4 == 0 and C >= 1
            and 1 <= n_blocks <= MAX_BLOCKS):
        return 0
    if B * N * max(C, D) >= 2**32 or B * D * max(T, N) >= 2**32 or B * N > TC_BM * 65535:
        return 0
    rows, cp = B * N, cdiv(C, 4) * 4
    _, ksplit = fill_slices(C, cdiv(rows, TC_BM) * cdiv(D, TC_BN), sms)
    parts = [n_blocks * D * cp if cp != C else 0, rows * D, rows * D, rows * cp,
             ksplit * rows * D]
    return sum(cdiv(p, 4) * 4 for p in parts)


class MirrorLib:
    @staticmethod
    def m2m_mixer_fwd_workspace_bytes(b, n, t, d, c, n_blocks, dev):
        return fwd_workspace_floats(b, n, t, d, c, n_blocks) * 4


# (B, N, T, D, C, blocks) -> (down-product slices, workspace bytes) on 132 SMs
PLANS = {
    "encoder_B32": ((32, 4, 32, 128, 3072, 1), 32, 3_801_088),
    "encoder_B512": ((512, 4, 32, 128, 3072, 1), 8, 35_651_584),
    "encoder_x4_B512": ((512, 4, 32, 128, 3072, 4), 8, 35_651_584),
    "fusion_B32": ((32, 8, 32, 128, 3078, 1), 25, 8_269_824),
    "fusion_B512": ((512, 8, 32, 128, 3078, 1), 4, 64_622_592),
    "fusion_x2_B512": ((512, 8, 32, 128, 3078, 2), 4, 66_199_552),
    "odd_widths_B7": ((7, 3, 7, 20, 46, 2), 2, 18_432),
    "batch_600": ((600, 4, 32, 128, 3072, 1), 6, 39_321_600),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_workspace_matches_the_plan(case):
    (B, N, T, D, C, K), ksplit, nbytes = PLANS[case]
    rows = B * N
    assert fill_slices(C, cdiv(rows, TC_BM) * cdiv(D, TC_BN), SMS)[1] == ksplit
    assert mk._fwd_workspace_bytes(MirrorLib, B, N, T, D, C, K, 0) == nbytes


def test_only_an_unaligned_channel_width_pads_w3():
    """W3 is copied (D x Cp per block) only where C is no multiple of 4: a
    stack's workspace grows by D x Cp a block at C = 3078 and not at 3072."""
    enc = [fwd_workspace_floats(512, 4, 32, 128, 3072, k) for k in (1, 2)]
    fus = [fwd_workspace_floats(512, 8, 32, 128, 3078, k) for k in (1, 2)]
    assert enc[1] == enc[0]
    assert fus[1] - fus[0] == 128 * 3080


@pytest.mark.parametrize("shape", [(4, 33, 32, 128, 3072, 1), (4, 4, 32, 130, 3072, 1),
                                   (4, 4, 32, 128, 3072, 33)],
                         ids=["too_many_tokens", "unaligned_width", "too_many_blocks"])
def test_shapes_the_kernels_do_not_take_raise(shape):
    with pytest.raises(ValueError, match="does not take"):
        mk._fwd_workspace_bytes(MirrorLib, *shape, 0)
