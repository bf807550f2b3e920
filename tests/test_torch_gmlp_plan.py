"""The gMLP block's workspace (K3f/K3b, ``csrc/gmlp.cu``).

The wrapper sizes its workspace with ``m2m_gmlp_workspace_bytes``. That C
function runs only where the kernels are built, so here it is mirrored in
Python (``gmlp_plan``: the arithmetic of ``make_plan``, ``plan_f32`` and
``plan_bf16``, of ``tile_common.cuh``'s slice planners and of
``wgmma_bf16.cuh``'s ``wg_slices``) behind a fake library, and the wrapper
is held to the mirror's byte counts at the gMLP config's shapes (encoder N =
49, fusion N = 99; D 128, F 768) at batches 1, 32, 512 and 600 and at the
odd widths of the card's edge tests, forward and backward, float32 and bf16,
pinned below. ``tests/test_torch_cuda_kernels.py`` holds the real function
to the same mirror on the card.

In float32 the workspace holds float32 operands and tc_gemm's slices, as
before the bf16 engine. In bf16 the products' operands lie in bf16 with
rows padded to 8 elements (Dp, Hp, Fp): xn, gated, the dout operand,
dgated, the rounded W_in, W_out and (backward) W_out^T; dpre as three bf16
planes; h / pm stays float32 (and holds the out-projection's slices where
the forward slices F/2); the slices follow the engine's tiles and 64-deep
stages; db_in and db_out take the producers' partials (per sample and per
32-row tile) in place of column slices.
"""

import pytest

from m2mixer_tpu_torch.ops import gmlp_kernel as gk
from test_torch_mixer_bwd_plan import row_slices
from test_torch_mixer_fwd_plan import SMEM_OPTIN, SMS, TC_BM, TC_BN, cdiv, fill_slices, wg_slices

MAX_SEQ, CHUNK, ROW_TILE, WARPS = 128, 64, 32, 8  # kMaxSeq, kChunk, kRowTile, kWarps
WG_BM, WG_BN = 128, 128  # the engine's tile: rows, and the 128-wide tile's columns


def sgu_floats(N, bwd):
    """sgu_layout(N, bwd).floats: sgu_w (nm x nm + 8), the chunk's v', t, u
    (and the backward's dgated) at nm x 72, sgu_b, (d sgu_b), mean, 1/std."""
    nm = cdiv(N, 16) * 16
    return nm * (nm + 8) + (4 if bwd else 3) * nm * (CHUNK + 8) + (5 if bwd else 4) * nm


def sgu_floats_bf16(N, bwd):
    """sgu_layout_bf16(N, bwd).floats: bf16(sgu_w) (nm x nm + 8 bf16), v' and
    (backward) dt's bits (nm x 72 bf16), t and u (nm x 72 each), (dgated: nm
    x 72 bf16, at least 512), sgu_b, (d sgu_b), mean, 1/std, each whole
    16-byte groups."""
    nm = cdiv(N, 16) * 16
    whole = lambda n: cdiv(n, 4) * 4  # noqa: E731
    rows_b, rows_f = nm * (CHUNK + 8) // 2, nm * (CHUNK + 8)
    regions = [nm * (nm + 8) // 2, rows_b, rows_f, rows_f, nm, nm, nm]
    if bwd:
        regions += [rows_b, max(rows_b, 512), nm]
    return sum(whole(n) for n in regions)


def gmlp_plan(B, N, D, F, bf16, sms=SMS):
    """make_plan's choices and workspace offsets (floats), or None for the
    shapes the kernels do not take (check_args, make_plan's refusals)."""
    if not (1 <= B <= 65535 and 1 <= N <= MAX_SEQ and D >= 1 and F >= 2 and F % 2 == 0):
        return None
    if B * N * max(F, D) >= 2**32:
        return None
    H, R = F // 2, B * N
    nsplit = max(1, min(cdiv(2 * sms, B), cdiv(H, CHUNK)))
    smem = ((sgu_floats_bf16 if bf16 else sgu_floats)(N, True) * 4,
            (WARPS * 6 * H if bf16 else 2 * ROW_TILE * H) * 4,
            (3 * ROW_TILE * D + 2 * ROW_TILE) * 4, WARPS * D * 4 if bf16 else 0)
    if max(smem) > SMEM_OPTIN:
        return None
    tiles = cdiv(R, ROW_TILE)
    p = dict(nsplit=nsplit, tiles=tiles)
    sizes = {}
    if bf16:
        Dp, Hp, Fp = (cdiv(n, 8) * 8 for n in (D, H, F))
        _, ysplit = wg_slices(H, cdiv(R, WG_BM) * cdiv(D, 64), sms, 1)
        _, xsplit = wg_slices(F, cdiv(R, WG_BM) * cdiv(D, WG_BN), sms, 1)
        _, wsplit = wg_slices(R, cdiv(D, WG_BM) * cdiv(F, WG_BN), sms, 1)
        _, vsplit = wg_slices(R, cdiv(H, WG_BM) * cdiv(D, WG_BN), sms, 1)
        op = lambda n: cdiv(n, 2)  # noqa: E731  (n bf16 in floats)
        fwd = dict(xn=op(R * Dp), act=max(R * F, ysplit * R * D if ysplit > 1 else 0),
                   gated=op(R * Hp), vstats=2 * R, w_in_r=op(D * Fp), w_out_r=op(H * Dp))
        bwd = dict(w_out_t=op(D * Hp), dout=op(R * Dp), dg=op(R * Hp), dpre=3 * op(R * Fp),
                   dxnp=xsplit * R * D, p_ln=tiles * 2 * D, p_vln=tiles * 2 * H,
                   p_sgu=B * nsplit * (N * N + N), p_win=wsplit * D * F, p_wout=vsplit * H * D,
                   p_bin=(B + tiles) * H, p_bout=tiles * D)
        p.update(Dp=Dp, Hp=Hp, Fp=Fp, ysplit=ysplit, xsplit=xsplit, wsplit=wsplit, vsplit=vsplit)
        whole = lambda n: cdiv(n, 4) * 4  # noqa: E731  (each buffer whole 16-byte groups)
        p["fwd_floats"] = sum(whole(v) for v in fwd.values())
        p["bwd_floats"] = p["fwd_floats"] + sum(whole(v) for v in bwd.values())
        sizes = {**fwd, **bwd}
    else:
        _, xsplit = fill_slices(F, cdiv(R, TC_BM) * cdiv(D, TC_BN), sms)
        _, wsplit = row_slices(R, cdiv(D, TC_BM) * cdiv(F, TC_BN), sms)
        fwd = dict(xn=R * D, act=R * F, gated=R * H, vstats=2 * R)
        bwd = dict(dout=R * D, dg=R * H, dpre=R * F, dxnp=xsplit * R * D, p_ln=tiles * 2 * D,
                   p_vln=tiles * 2 * H, p_sgu=B * nsplit * (N * N + N), p_win=wsplit * D * F,
                   p_wout=wsplit * H * D, p_col=wsplit * (F + D))
        p.update(xsplit=xsplit, wsplit=wsplit)
        p["fwd_floats"] = cdiv(sum(fwd.values()), 4) * 4
        p["bwd_floats"] = p["fwd_floats"] + sum(bwd.values())
        sizes = {**fwd, **bwd}
    p["sizes"] = sizes
    return p


def workspace_floats(B, N, D, F, backward, bf16, sms=SMS):
    plan = gmlp_plan(B, N, D, F, bf16, sms)
    return 0 if plan is None else plan["bwd_floats" if backward else "fwd_floats"]


class MirrorLib:
    @staticmethod
    def m2m_gmlp_workspace_bytes(b, n, d, f, backward, bf16, dev):
        return workspace_floats(b, n, d, f, backward, bf16) * 4


ENC, FUSION = dict(N=49, D=128, F=768), dict(N=99, D=128, F=768)
# the card's edge shapes (test_torch_cuda_kernels.py's GMLP_TC_SHAPES)
ODD = {"odd_widths": (5, 13, 20, 44), "n65": (3, 65, 24, 40), "n128": (2, 128, 16, 48),
       "encoder_ragged": (37, 49, 128, 768)}
# (B, N, D, F) -> (float32 forward, float32 backward, bf16 forward, bf16
# backward) bytes on 132 SMs
PLANS = {
    (1, 49, 128, 768): (251_280, 1_764_672, 496_016, 1_833_792),
    (32, 49, 128, 768): (8_040_704, 34_661_632, 6_729_984, 32_734_976),
    (512, 49, 128, 768): (128_651_264, 291_230_720, 103_256_064, 285_417_472),
    (600, 49, 128, 768): (150_763_200, 339_043_200, 120_952_512, 331_040_640),
    (1, 99, 128, 768): (507_680, 3_671_872, 701_216, 3_408_704),
    (32, 99, 128, 768): (16_245_504, 60_452_608, 13_296_384, 60_829_440),
    (512, 99, 128, 768): (259_928_064, 585_221_120, 208_318_464, 567_939_072),
    (600, 99, 128, 768): (304_603_200, 696_620_224, 244_072_512, 662_320_320),
    (5, 13, 20, 44): (22_880, 71_360, 21_184, 68_464),
    (3, 65, 24, 40): (67_088, 248_056, 54_368, 218_224),
    (2, 128, 16, 48): (92_160, 369_152, 73_984, 339_904),
    (37, 49, 128, 768): (9_297_072, 39_689_504, 7_735_472, 37_796_640),
}
CASES = sorted(PLANS)


@pytest.mark.parametrize("dims", CASES, ids=lambda d: "B{}-N{}-D{}-F{}".format(*d))
def test_workspace_matches_the_plan(dims):
    """The wrapper's workspace behind the mirror, pinned: float32 and bf16,
    forward and backward."""
    got = tuple(gk._workspace_bytes(MirrorLib, *dims, backward, bf16, 0)
                for bf16 in (False, True) for backward in (False, True))
    assert got == PLANS[dims]


def pr12_bf16_bytes(B, N, D, F, backward):
    """The bf16 workspace before the engine: the float32 plan plus float32
    copies of the rounded W_in and W_out in the forward's part."""
    extra = D * F + (F // 2) * D
    return 4 * (workspace_floats(B, N, D, F, backward, 0) + extra)


def test_bf16_backward_workspace_shrinks_at_fusion_512():
    """At the fusion shape, batch 512: xn, gated, dgated and dout halve (104
    MB), dpre's three bf16 planes take 78 MB more than a float32 dpre, the
    column slices give way to the producers' partials: 585.8 -> 567.9 MB;
    the forward's 260.5 -> 208.3 MB (xn and gated halve)."""
    dims = (512, 99, 128, 768)
    before = [pr12_bf16_bytes(*dims, b) for b in (0, 1)]
    after = [4 * workspace_floats(*dims, b, 1) for b in (0, 1)]
    assert before == [260_517_888, 585_810_944]
    assert after == [208_318_464, 567_939_072]
    f32, bf = gmlp_plan(*dims, 0)["sizes"], gmlp_plan(*dims, 1)["sizes"]
    for k in ("xn", "gated", "dout", "dg"):
        assert bf[k] * 2 == f32[k], k
    assert bf["dpre"] * 2 == 3 * f32["dpre"]
    assert bf["act"] == f32["act"]  # h / pm: float32 in both


@pytest.mark.parametrize("name", sorted(ODD))
def test_bf16_rows_are_padded_to_whole_16_byte_groups(name):
    """bf16 takes the widths float32 takes: every operand's rows are D, F/2
    and F rounded up to 8 (TMA's 16-byte rows of bf16; the maps give the
    true widths, so the pads read as zeros)."""
    B, N, D, F = ODD[name]
    p = gmlp_plan(B, N, D, F, 1)
    assert (p["Dp"], p["Hp"], p["Fp"]) == tuple(cdiv(n, 8) * 8 for n in (D, F // 2, F))
    assert all(v % 8 == 0 for v in (p["Dp"], p["Hp"], p["Fp"]))
    R = B * N
    assert p["sizes"]["xn"] == cdiv(R * p["Dp"], 2)
    assert p["sizes"]["dpre"] == 3 * cdiv(R * p["Fp"], 2)
    assert gmlp_plan(B, N, D, F, 0) is not None


# (B, N) -> (ysplit, xsplit, wsplit, vsplit) on 132 SMs at D 128, F 768: the
# out-projection's slices of F/2 (128 x 64 tiles), dxn's of F (128 x 128),
# dW_in's (6 tiles) and dW_out's (3 tiles) of the rows
SLICES = {(1, 49): (6, 12, 1, 1), (32, 49): (6, 6, 13, 25), (512, 49): (1, 1, 22, 44),
          (600, 49): (1, 1, 22, 42), (32, 99): (3, 6, 17, 25), (512, 99): (1, 1, 22, 44)}


@pytest.mark.parametrize("bn", sorted(SLICES), ids=lambda d: "B{}-N{}".format(*d))
def test_bf16_slices_are_whole_stages(bn):
    """The engine's slices, pinned: each a whole number of 64-deep stages
    that covers its depth once; at batch 512 the out-projection and dxn take
    one slice (their tiles fill the card), at 32 several."""
    B, N = bn
    p = gmlp_plan(B, N, 128, 768, 1)
    assert (p["ysplit"], p["xsplit"], p["wsplit"], p["vsplit"]) == SLICES[bn]
    R = B * N
    for depth, tiles, waves, split in ((384, cdiv(R, WG_BM) * 2, 1, p["ysplit"]),
                                       (768, cdiv(R, WG_BM), 1, p["xsplit"]),
                                       (R, 6, 1, p["wsplit"]), (R, 3, 1, p["vsplit"])):
        size, n = wg_slices(depth, tiles, SMS, waves)
        assert n == split and size % 64 == 0 and (n - 1) * size < depth <= n * size


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("dims", [(2, 129, 16, 32), (2, 6, 16, 33), (2, 6, 16, 4096)],
                         ids=["too_many_tokens", "odd_d_ffn", "v_rows_outgrow_smem"])
def test_shapes_the_kernels_do_not_take_raise(dims, bf16):
    with pytest.raises(ValueError, match="does not take"):
        gk._workspace_bytes(MirrorLib, *dims, True, bf16, 0)
