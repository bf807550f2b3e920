"""The pipeline mixer forward's workspace (K1f/K2f, ``csrc/mixer_fwd.cu``).

The wrapper sizes its workspace with ``m2m_mixer_fwd_workspace_bytes``. That
C function runs only where the kernels are built, so here it is mirrored in
Python (``fwd_workspace_floats``, the arithmetic of ``make_fwd_plan``, of
``tile_common.cuh``'s slice planner and of ``wgmma_bf16.cuh``'s
``wg_slices``) behind a fake library, and the wrapper is held to the
mirror's byte counts at the B and L configs' shapes, float32 and bf16,
pinned below. ``tests/test_torch_cuda_kernels.py`` holds the real function
to the same mirror on the card.

In bf16 compute every product runs on the wgmma engine, whose operands lie
in the workspace as bf16: z, h2 (rows x Cp, Cp = C rounded up to 8), the
W3 and W4 copies and, on the token pipeline, yt (B*D x Np) and ht (B*D x
Tp) with the padded token weights (Np, Tp: N and T rounded up to 8); x1,
the down product's slices (the engine's 128 x 128 tiles and 64-deep
stages) and tt stay float32. The hidden width must be a multiple of 8 (TMA
reads whole 16-byte rows).
"""

import pytest

from m2mixer_tpu_torch.ops import mixer_kernel as mk

SMS = 132  # an H100 SXM
TC_BM, TC_BN, TC_K, MAX_SPLIT = 128, 64, 32, 32  # kTcBM, kTcBN, kTcK, kMaxSplit
REG_TOKENS, MAX_BLOCKS = 32, 32  # kMaxTokens (the register token FF), kMaxBlocks
SMEM_OPTIN = 232_448  # shared memory a CTA may opt into on an H100
MAX_ROW_SPLIT = 128  # kMaxRowSplit
WG_BM, WG_BN, WG_BK = 128, 128, 64  # the wgmma engine: kWgBM, kWgBN, kWgBK


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fill_slices(depth: int, tiles: int, sms: int):
    """(slice, split) of tile_common.cuh::fill_slices: slices of whole kTcK
    stages for two CTAs an SM, at most kMaxSplit."""
    n = min(2 * sms // tiles, MAX_SPLIT)
    size = cdiv(cdiv(depth, max(n, 1)), TC_K) * TC_K
    return size, cdiv(depth, size)


def wg_slices(depth, tiles, sms, waves):
    """(slice, split) of wgmma_bf16.cuh::wg_slices: about ``waves`` CTAs an SM,
    slices of whole 64-deep stages, at most kMaxRowSplit."""
    n = min(max(cdiv(waves * sms, tiles), 1), MAX_ROW_SPLIT)
    size = cdiv(cdiv(depth, n), WG_BK) * WG_BK
    return size, cdiv(depth, size)


def down_slices(B, N, D, C, bf16, sms=SMS):
    """(slice, split) of the down product's depth C: tc_gemm's wide tiles in
    float32, the engine's 128 x 128 tiles (one CTA an SM) in bf16."""
    rows = B * N
    if bf16:
        return wg_slices(C, cdiv(rows, WG_BM) * cdiv(D, WG_BN), sms, 1)
    return fill_slices(C, cdiv(rows, TC_BM) * cdiv(D, TC_BN), sms)


def fwd_workspace_floats(B, N, T, D, C, n_blocks, bf16=0, sms=SMS):
    """make_fwd_plan's workspace in floats, or 0 for shapes the kernels do
    not take (check_args; in bf16 also D % 8): W3 copies (D x Cp a block)
    where C % 4 or in bf16, W4 copies (C x D a block) in bf16, x1, z, h2 (rows
    x Cp), the down product's slices of C (ksplit x rows x D) and, where the
    token FF runs as products (above REG_TOKENS tokens, or where one sample's
    rows do not fit the register route's prefix tile), the token pipeline's
    yt, ht, tt (B*D x Np, Tp, N) with, in bf16, the padded token weights (N x
    Tp and T x Np); a bf16 element takes half a float; each buffer rounded up
    to whole 16-byte groups."""
    if not (B >= 1 and N >= 1 and T >= 1 and D >= 4 and D % 4 == 0 and C >= 1
            and 1 <= n_blocks <= MAX_BLOCKS):
        return 0
    if B * N * max(C, D) >= 2**32 or B * D * max(T, N) >= 2**32 or B * N > TC_BM * 65535:
        return 0
    if bf16 and D % 8:
        return 0
    reg = N <= REG_TOKENS and (2 * N * D + 2 * N * T + T + N) * 4 <= SMEM_OPTIN
    if not reg and (B * D > TC_BM * 65535 or B > 65535):
        return 0
    rows, cols = B * N, B * D
    cp, np_, tp = (cdiv(C, 8) * 8, cdiv(N, 8) * 8, cdiv(T, 8) * 8) if bf16 else \
        (cdiv(C, 4) * 4, N, T)
    _, ksplit = down_slices(B, N, D, C, bf16, sms)
    op = (lambda n: cdiv(n, 2)) if bf16 else (lambda n: n)  # noqa: E731
    tok = 0 if reg else 1
    parts = [op(n_blocks * D * cp) if cp != C or bf16 else 0, op(n_blocks * C * D) if bf16 else 0,
             tok * op(N * tp + T * np_) if bf16 else 0, rows * D, op(rows * D), op(rows * cp),
             ksplit * rows * D, tok * op(cols * np_), tok * op(cols * tp), tok * cols * N]
    return sum(cdiv(p, 4) * 4 for p in parts)


class MirrorLib:
    @staticmethod
    def m2m_mixer_fwd_workspace_bytes(b, n, t, d, c, n_blocks, bf16, dev):
        return fwd_workspace_floats(b, n, t, d, c, n_blocks, bf16) * 4


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
    "l_image_B512": ((512, 16, 256, 512, 4096, 1), 1, 184_549_376),
    "l_audio_x4_B512": ((512, 64, 256, 512, 4096, 4), 1, 1_140_850_688),
    "l_fusion_B32": ((32, 80, 256, 512, 4096, 1), 1, 84_934_656),
    "l_fusion_x2_B512": ((512, 80, 256, 512, 4096, 2), 1, 1_358_954_496),
}
# the same shapes in bf16 compute (one forward route at either precision, the
# products on the wgmma engine: bf16 operands, the engine's slices)
BF16_PLANS = {"encoder_B512": 24_117_248, "fusion_x2_B512": 42_015_744,
              "l_image_B512": 117_440_512, "l_audio_x4_B512": 704_708_608,
              "l_fusion_x2_B512": 822_165_504}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_workspace_matches_the_plan(case):
    (B, N, T, D, C, K), ksplit, nbytes = PLANS[case]
    rows = B * N
    assert fill_slices(C, cdiv(rows, TC_BM) * cdiv(D, TC_BN), SMS)[1] == ksplit
    assert mk._fwd_workspace_bytes(MirrorLib, B, N, T, D, C, K, False, 0) == nbytes


@pytest.mark.parametrize("case", sorted(BF16_PLANS))
def test_bf16_workspace_matches_the_plan(case):
    (B, N, T, D, C, K), _, _ = PLANS[case]
    assert mk._fwd_workspace_bytes(MirrorLib, B, N, T, D, C, K, True, 0) == BF16_PLANS[case]


# The bf16 forward at the B config's encoder (N = 4, C = 3072) and fusion
# (N = 8, C = 3078) shapes, one block, D 128, T 32: (N, B) -> (down-product
# slices, workspace bytes) on 132 SMs
B_BF16_PLANS = {(4, 1): (48, 1_698_816), (4, 32): (48, 5_603_328), (4, 128): (24, 11_403_264),
                (4, 512): (8, 24_117_248), (4, 4096): (2, 131_596_288),
                (8, 32): (49, 9_772_544), (8, 512): (5, 40_439_296),
                (8, 4096): (1, 245_370_368)}


@pytest.mark.parametrize("n,b", sorted(B_BF16_PLANS))
def test_bf16_forward_plan_at_the_b_shapes(n, b):
    """The pipeline with the token FF in registers: bf16's workspace holds
    the W3 (D x Cp, Cp = C rounded up to 8) and W4 (C x D) copies, z and h2
    (rows x Cp) at two bytes an element, x1 and the engine's down-product
    slices in float32, and no token-pipeline buffers."""
    D, T, C = 128, 32, 3072 if n == 4 else 3078
    ksplit, nbytes = B_BF16_PLANS[(n, b)]
    assert down_slices(b, n, D, C, True)[1] == ksplit
    assert mk._fwd_workspace_bytes(MirrorLib, b, n, T, D, C, 1, True, 0) == nbytes
    rows, cp = b * n, cdiv(C, 8) * 8
    half = lambda k: cdiv(k, 8) * 16  # noqa: E731  k bf16 elements in whole 16-byte groups
    assert nbytes == (half(D * cp) + half(C * D) + 4 * rows * D + half(rows * D)
                      + half(rows * cp) + 4 * ksplit * rows * D)


# The bf16 token pipeline above 32 tokens (2 blocks): yt's rows padded to Np
# = N rounded up to 8, ht's to Tp; (B, N, T, D, C) -> workspace bytes
TOKEN_BF16_PLANS = {(19, 33, 16, 32, 64): 447_968, (19, 40, 16, 32, 64): 524_800,
                    (7, 80, 48, 64, 96): 931_840}


@pytest.mark.parametrize("shape", sorted(TOKEN_BF16_PLANS))
def test_bf16_token_pipeline_plan(shape):
    """The wrapper sizes the bf16 token pipeline as the mirror does: yt
    (B*D x Np) and ht (B*D x Tp) in bf16, the token weights padded (N x Tp,
    T x Np), tt (B*D x N) in float32."""
    B, N, T, D, C = shape
    assert mk._fwd_workspace_bytes(MirrorLib, B, N, T, D, C, 2, True, 0) == \
        TOKEN_BF16_PLANS[shape]
    f32 = fwd_workspace_floats(B, N, T, D, C, 2)
    np_, tp = cdiv(N, 8) * 8, cdiv(T, 8) * 8
    # float32's yt and ht (B*D x N, T) against bf16's padded halves
    assert 4 * f32 - TOKEN_BF16_PLANS[shape] > 4 * B * D * (N + T) - 2 * B * D * (np_ + tp) > 0


@pytest.mark.parametrize("D", [256, 512])
def test_the_l_image_mixer_keeps_the_register_route(D):
    """The L image mixer (16 tokens) fits the register route's prefix tile at
    D = 256 and 512 in both dtypes: no token-pipeline buffers; bf16 holds the
    weight copies, z and h2 at two bytes an element, x1 and the engine's
    down-product slices in float32."""
    B, N, T, C = 512, 16, 256, 4096
    rows = B * N
    half = lambda k: cdiv(k, 8) * 16  # noqa: E731  k bf16 elements in whole 16-byte groups
    _, ks32 = down_slices(B, N, D, C, False)
    _, ks16 = down_slices(B, N, D, C, True)
    # float32: x1, z, h2 (C % 4 == 0: no W3 copy) and the down product's slices
    assert 4 * fwd_workspace_floats(B, N, T, D, C, 1) == \
        4 * (2 * rows * D + rows * C + ks32 * rows * D)
    assert 4 * fwd_workspace_floats(B, N, T, D, C, 1, 1) == \
        2 * half(D * C) + 4 * rows * D + half(rows * D) + half(rows * C) + 4 * ks16 * rows * D


@pytest.mark.parametrize("d", [12, 20, 36])
def test_bf16_needs_hidden_width_of_8(d):
    """TMA reads whole 16-byte rows: a bf16 forward at a hidden width that is
    no multiple of 8 is refused (the wrapper raises), float32 takes it."""
    with pytest.raises(ValueError, match="hidden_dim % 8"):
        mk._fwd_workspace_bytes(MirrorLib, 7, 4, 16, d, 64, 1, True, 0)
    assert mk._fwd_workspace_bytes(MirrorLib, 7, 4, 16, d, 64, 1, False, 0) > 0


def test_only_an_unaligned_channel_width_pads_w3():
    """W3 is copied (D x Cp per block) only where C is no multiple of 4: a
    stack's workspace grows by D x Cp a block at C = 3078 and not at 3072."""
    enc = [fwd_workspace_floats(512, 4, 32, 128, 3072, k) for k in (1, 2)]
    fus = [fwd_workspace_floats(512, 8, 32, 128, 3078, k) for k in (1, 2)]
    assert enc[1] == enc[0]
    assert fus[1] - fus[0] == 128 * 3080


# too_many_tokens: more than the dropout masks' 32-bit element counts take
@pytest.mark.parametrize("shape", [(1, 2**24, 8, 256, 8, 1), (4, 4, 32, 130, 3072, 1),
                                   (4, 4, 32, 128, 3072, 33)],
                         ids=["too_many_tokens", "unaligned_width", "too_many_blocks"])
def test_shapes_the_kernels_do_not_take_raise(shape):
    with pytest.raises(ValueError, match="does not take"):
        mk._fwd_workspace_bytes(MirrorLib, *shape, False, 0)


def test_more_than_32_tokens_take_the_token_pipeline():
    """Above 32 tokens the plan adds the token FF's buffers (yt, ht, tt) and
    no token cap: 33 tokens plan, and the step from 32 to 33 is exactly
    those buffers and the larger x1, z, h2 and slices."""
    B, T, D, C = 4, 32, 128, 3072
    at32, at33 = (fwd_workspace_floats(B, n, T, D, C, 1) for n in (32, 33))
    assert at32 and at33
    _, ksplit = fill_slices(C, cdiv(B * 33, TC_BM) * cdiv(D, TC_BN), SMS)
    base33 = sum(cdiv(p, 4) * 4 for p in (B * 33 * D, B * 33 * D, B * 33 * C,
                                          ksplit * B * 33 * D))
    assert at33 - base33 == sum(cdiv(p, 4) * 4 for p in (B * D * 33, B * D * T, B * D * 33))
