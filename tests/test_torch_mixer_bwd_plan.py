"""The mixer backward's workspace (K1b/K2b, ``csrc/mixer_bwd.cu``).

The wrapper sizes its workspace with ``m2m_mixer_bwd_workspace_bytes``. That
C function runs only where the kernels are built, so here it is mirrored in
Python (``bwd_workspace_floats``: the arithmetic of ``make_plan``, of
``tile_common.cuh``'s slice planners and of ``wgmma_bf16.cuh``'s
``wg_slices``) behind a fake library, and the wrapper is held to the
mirror's byte counts at the B and L configs' shapes, float32 and bf16,
pinned below. ``tests/test_torch_cuda_kernels.py`` holds the real function
to the same mirror on the card.

In bf16 compute the channel FF's operands lie in the workspace as bf16 (W3
and W4^T padded to Cp = C rounded up to 8, z, da4 and h2), da3 as three bf16
planes (hi, mid, lo), and the dz and weight-gradient slices follow the wgmma
engine's 128 x 128 tiles and 64-deep stages; float32 compute keeps float32
operands (Cp = C rounded up to 4) and tc_gemm's slices.
"""

import pytest

from m2mixer_tpu_torch.ops import mixer_kernel as mk
from test_torch_mixer_fwd_plan import (MAX_BLOCKS, MAX_ROW_SPLIT, MAX_SPLIT, REG_TOKENS,
                                       SMEM_OPTIN, SMS, TC_BM, TC_BN, TC_K, WG_BK, WG_BM, WG_BN,
                                       cdiv, fill_slices, wg_slices)
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

MAX_SLICE_ROWS = 2304  # kMaxSliceRows
THREADS, LN_ROWS = 256, 16  # kThreads, kLnRows


def split_depth(depth, n):
    size = cdiv(cdiv(depth, max(n, 1)), TC_K) * TC_K
    return size, cdiv(depth, size)


def row_slices(rows, tiles, sms):
    n = min(cdiv(2 * sms, tiles), MAX_SPLIT)
    n *= cdiv(cdiv(rows, n), MAX_SLICE_ROWS)
    n = min(n, MAX_ROW_SPLIT)
    return split_depth(rows, min(n, cdiv(rows, 64)))


def col_plan(rows, cols, sms):
    cs = min(cdiv(2 * sms, cdiv(cols, THREADS)), MAX_ROW_SPLIT, cdiv(rows, 16))
    size = cdiv(rows, cs)
    return size, cdiv(rows, size)


def bwd_plan(B, N, T, D, C, n_blocks, final_ln, bf16=0, sms=SMS):
    """make_plan's choices and workspace (floats), or None for shapes the
    kernels do not take (check_args, make_plan's refusals)."""
    if not (B >= 1 and N >= 1 and T >= 1 and D >= 1 and C >= 1 and 1 <= n_blocks <= MAX_BLOCKS):
        return None
    if B * N * max(C, D) >= 2**32 or B * D * max(T, N) >= 2**32:
        return None
    if B * N > TC_BM * 65535 or C > TC_BM * 65535:
        return None
    R, cols = B * N, B * D
    prefix = lambda tb: (2 * tb * N * D + 2 * N * T + T + N) * 4  # noqa: E731
    rows_smem = lambda tb: (5 * tb * N * D + 4 * tb * N + 2 * N * T + T + N  # noqa: E731
                            + tb * D * (2 * T + N))
    reg = N <= REG_TOKENS and rows_smem(1) * 4 <= SMEM_OPTIN and prefix(1) <= SMEM_OPTIN
    ln_smem = lambda rows: (3 * rows * D + 2 * rows) * 4  # noqa: E731  ln_bwd_smem_bytes
    ln_rows = LN_ROWS  # kLnRows, or as many rows as fit a CTA
    while ln_rows > 1 and ln_smem(ln_rows) > SMEM_OPTIN:
        ln_rows -= 1
    ln_tiles = cdiv(R, ln_rows)
    if (not reg or final_ln) and ln_smem(ln_rows) > SMEM_OPTIN:
        return None
    p = dict(reg=reg, ln_rows=ln_rows)
    if reg:
        tb = min(THREADS // D if THREADS // D > 1 else 1, B)
        while tb > 1 and rows_smem(tb) * 4 > SMEM_OPTIN:
            tb -= 1
        if rows_smem(tb) * 4 > SMEM_OPTIN:
            return None
        p["tiles"] = cdiv(B, tb)
        tsplit = tcsplit = 0
    else:
        if cols > TC_BM * 65535 or B > 65535:
            return None
        nc = min(N, 32)
        while nc > 0 and nc * (D + 1) * 4 > SMEM_OPTIN:
            nc -= 1
        if not nc:
            return None
        t1 = cdiv(N, TC_BM) * cdiv(T, TC_BN)
        t2 = cdiv(T, TC_BM) * cdiv(N, TC_BN)
        _, tsplit = row_slices(cols, max(t1, t2), sms)
        _, tcsplit = col_plan(cols, max(T, N), sms)
    if bf16:
        if D % 8:
            return None
        cp = cdiv(C, 8) * 8
        _, ksplit = wg_slices(C, cdiv(R, WG_BM) * cdiv(D, WG_BN), sms, 1)
        p["wslice"], wsplit = wg_slices(R, 2 * cdiv(D, WG_BM) * cdiv(C, WG_BN), sms, 2)
    else:
        cp = cdiv(C, 4) * 4
        _, ksplit = fill_slices(C, cdiv(R, TC_BM) * cdiv(D, TC_BN), sms)
        p["wslice"], wsplit = row_slices(R, cdiv(D, TC_BM) * cdiv(C, TC_BN), sms)
    _, csplit = col_plan(R, C, sms)
    part = p["tiles"] * (4 * D + 2 * N * T + T + N) if reg else 0
    if final_ln:
        part = max(part, ln_tiles * 2 * D)
    tok = 0 if reg else 1
    chan = (lambda n: cdiv(n, 2)) if bf16 else (lambda n: n)  # noqa: E731
    sizes = dict(
        w3p=chan(D * cp), w4t=chan(D * cp), z=chan(R * D), da4=chan(R * D), h2=chan(R * cp),
        da3=(3 if bf16 else 1) * chan(R * cp), dzp=ksplit * R * D, p_w3=wsplit * D * C,
        p_w4=wsplit * C * D, p_col=csplit * (C + D), part=part,
        ping=2 * R * D if n_blocks > 1 or final_ln else 0,
        twr=tok * 2 * N * T, x1=tok * R * D, yt=tok * cols * N, ht=tok * cols * T,
        a1=tok * cols * T, da1=tok * cols * T, tt=tok * cols * N, da2=tok * cols * N,
        dx1=tok * R * D, dy=tok * R * D, p_ln1=tok * ln_tiles * 2 * D, p_ln2=tok * ln_tiles * 2 * D,
        p_w1=tok * tsplit * N * T, p_w2=tok * tsplit * T * N, p_tcol=tok * tcsplit * (T + N))
    p.update(Cp=cp, ksplit=ksplit, wsplit=wsplit, csplit=csplit, sizes=sizes,
             floats=sum(cdiv(v, 4) * 4 for v in sizes.values()))
    return p


def bwd_workspace_floats(B, N, T, D, C, n_blocks, final_ln, bf16=0, sms=SMS):
    plan = bwd_plan(B, N, T, D, C, n_blocks, final_ln, bf16, sms)
    return 0 if plan is None else plan["floats"]


class MirrorLib:
    @staticmethod
    def m2m_mixer_bwd_workspace_bytes(b, n, t, d, c, n_blocks, final_ln, bf16, dev):
        return bwd_workspace_floats(b, n, t, d, c, n_blocks, final_ln, bf16) * 4


ENC = dict(N=4, T=32, D=128, C=3072)
FUSION = dict(N=8, T=32, D=128, C=3078)
L_IMAGE = dict(N=16, T=256, D=512, C=4096)
L_AUDIO = dict(N=64, T=256, D=512, C=4096)
L_FUSION = dict(N=80, T=256, D=512, C=4096)
GEOMS = {"enc": ENC, "fusion": FUSION, "l_image": L_IMAGE, "l_audio": L_AUDIO,
         "l_fusion": L_FUSION}
# (geometry, batch, blocks, final LN) -> (float32 bytes, bf16 bytes) on 132 SMs:
# K1b is one block without the final LN, K2b the stacks the configs run
PLANS = {
    ("enc", 32, 1, 0): (14_964_992, 14_375_168),
    ("enc", 512, 1, 0): (83_942_400, 81_320_960),
    ("enc", 512, 4, 1): (86_039_552, 83_418_112),
    ("fusion", 1, 1, 0): (6_630_592, 5_147_840),
    ("fusion", 7, 1, 0): (8_528_096, 7_610_592),
    ("fusion", 32, 1, 0): (25_881_472, 27_319_168),
    ("fusion", 512, 1, 0): (136_932_352, 135_355_392),
    ("fusion", 512, 2, 1): (141_126_656, 139_549_696),
    ("fusion", 600, 1, 0): (154_171_264, 152_594_304),
    ("l_image", 512, 4, 1): (1_353_148_416, 1_294_428_160),
    ("l_audio", 512, 4, 1): (2_945_009_664, 2_634_631_168),
    ("l_fusion", 1, 1, 0): (62_730_240, 54_177_792),
    ("l_fusion", 7, 1, 0): (101_271_552, 92_882_944),
    ("l_fusion", 32, 1, 0): (238_938_112, 230_549_504),
    ("l_fusion", 512, 1, 0): (3_263_817_728, 2_903_107_584),
    ("l_fusion", 512, 2, 1): (3_442_075_648, 3_081_365_504),
    ("l_fusion", 600, 1, 0): (3_833_391_104, 3_391_154_176),
}


def case_id(case):
    geom, b, k, ln = case
    return f"{geom}-B{b}-x{k}" + ("-ln" if ln else "")


@pytest.mark.parametrize("case", sorted(PLANS), ids=case_id)
@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
def test_workspace_matches_the_plan(case, bf16):
    geom, B, K, ln = case
    g = GEOMS[geom]
    got = mk._bwd_workspace_bytes(MirrorLib, B, g["N"], g["T"], g["D"], g["C"], K, bool(ln),
                                  bool(bf16), 0)
    assert got == PLANS[case][bf16]


def test_bf16_operands_are_bf16():
    """In bf16 the channel operands take half their float32 bytes and da3's
    three planes one and a half times; Cp is C rounded up to 8 (TMA's 16-byte
    rows of bf16): the fusion mixer's C = 3078 becomes 3080 in both dtypes."""
    f32, bf = (bwd_plan(512, **FUSION, n_blocks=1, final_ln=0, bf16=b) for b in (0, 1))
    assert f32["Cp"] == bf["Cp"] == 3080
    assert bwd_plan(512, **dict(FUSION, C=3076), n_blocks=1, final_ln=0, bf16=1)["Cp"] == 3080
    assert bwd_plan(512, **dict(FUSION, C=3076), n_blocks=1, final_ln=0, bf16=0)["Cp"] == 3076
    for k in ("w3p", "w4t", "z", "da4", "h2"):
        assert bf["sizes"][k] * 2 == f32["sizes"][k], k
    assert bf["sizes"]["da3"] * 2 == 3 * f32["sizes"]["da3"]


def pr12_bf16_floats(B, N, T, D, C, n_blocks, final_ln):
    """The bf16 workspace before the wgmma engine: the float32 plan, with
    float32 slots holding bf16 values (w3p, w4t, z, da4, h2) and da3 in
    float32."""
    return bwd_workspace_floats(B, N, T, D, C, n_blocks, final_ln, 0)


def test_bf16_workspace_shrinks_at_l_fusion():
    """At L fusion, batch 512, one block: the bf16 workspace is 3.26 GB with
    float32 slots for bf16 values, 2.90 GB with them gone (361 MB, 11% less),
    though da3's three planes take 1.5x a float32 da3."""
    before = pr12_bf16_floats(512, **L_FUSION, n_blocks=1, final_ln=0) * 4
    after = bwd_workspace_floats(512, **L_FUSION, n_blocks=1, final_ln=0, bf16=1) * 4
    assert (before, after) == (3_263_817_728, 2_903_107_584)
    assert before - after == 360_710_144


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_bf16_slices_are_whole_stages(geom):
    """The wgmma engine's slices of C (dz) and of the rows (dW3, dW4^T) are
    whole 64-deep stages, so no stage straddles two slices, and they cover
    the depth once."""
    g = GEOMS[geom]
    for B in (1, 7, 32, 512, 600):
        R = B * g["N"]
        kslice, ksplit = wg_slices(g["C"], cdiv(R, WG_BM) * cdiv(g["D"], WG_BN), SMS, 1)
        wslice, wsplit = wg_slices(R, 2 * cdiv(g["D"], WG_BM) * cdiv(g["C"], WG_BN), SMS, 2)
        for size, split, depth in ((kslice, ksplit, g["C"]), (wslice, wsplit, R)):
            assert size % WG_BK == 0
            assert (split - 1) * size < depth <= split * size


def test_bf16_needs_whole_16_byte_rows_of_z():
    """z and da4 are TMA operands in bf16: the kernels run on rows of a
    multiple of 8, so the wrapper pads a hidden width of 20 to 24 (zeros in
    the pad) and the plan takes that pitch; the unpadded width stays refused
    by the library. float32 pads 20 to nothing (a multiple of 4)."""
    assert (mk._pitch(20, True), mk._pitch(20, False)) == (24, 20)
    with pytest.raises(ValueError, match="does not take"):
        mk._bwd_workspace_bytes(MirrorLib, 4, 4, 16, 20, 64, 1, False, True, 0)
    assert mk._bwd_workspace_bytes(MirrorLib, 4, 4, 16, 24, 64, 1, False, True, 0) == PADDED_BWD
    assert mk._bwd_workspace_bytes(MirrorLib, 4, 4, 16, 20, 64, 1, False, False, 0) > 0


PADDED_BWD = 31_024  # bf16, B 4, N 4, T 16, D 20 padded to 24, C 64, one block


@pytest.mark.parametrize("final_ln", [False, True], ids=["block", "stack"])
def test_ln_backward_rows_follow_the_width(final_ln):
    """An LN backward holds 3 floats a column and 2 a row for each of its
    rows in shared memory: at D = 1300 the 16-row tile (249,728 bytes)
    outgrows a CTA, and the plan takes 14 rows a CTA where it refused before;
    at the shipped widths it keeps 16."""
    p = bwd_plan(64, 4, 32, 1300, 256, 2, final_ln)
    assert p is not None and p["ln_rows"] == 14
    assert bwd_plan(512, 4, 32, 128, 3072, 4, final_ln)["ln_rows"] == LN_ROWS


@pytest.mark.parametrize("shape", [(1, 2**24, 8, 256, 8, 1), (4, 4, 32, 128, 3072, 33)],
                         ids=["too_many_tokens", "too_many_blocks"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_shapes_the_kernels_do_not_take_raise(shape, bf16):
    with pytest.raises(ValueError, match="does not take"):
        mk._bwd_workspace_bytes(MirrorLib, *shape, False, bf16, 0)
