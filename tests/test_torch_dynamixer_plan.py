"""The DynaMixerOp's workspace (K4f/K4b, ``csrc/dynamixer.cu``).

The wrapper sizes its workspace with ``m2m_dyna_workspace_bytes``. That C
function runs only where the kernels are built, so here it is mirrored in
Python (``dyna_plan``: the arithmetic of ``make_plan``, of
``tile_common.cuh``'s ``row_slices`` and of ``wgmma_bf16.cuh``'s
``wg_slices``) behind a fake library, and the wrapper is held to the
mirror's byte counts, pinned below, at the DynaMixer config's op (L 7, C
256, H 8, R 2) at batches 1, 32, 512 and 600 (S = 7 x batch) and at the two
lifted shapes, whose sequence would outgrow a CTA's shared memory (L 33, C
1280, H 8, R 2; L 64, C 512, H 4, R 3), forward and backward, float32 and
bf16. ``tests/test_torch_cuda_kernels.py`` holds the real function to the
same mirror on the card.

Both dtypes run every product over all rows through device memory. In bf16
the operands lie in bf16 with rows padded to 8 (x, the three weights, gin,
mixed, d_mixed, d_comp, g's and d_logit's three planes), the logits and
d_logit float32; in float32 comp, gin, the logits, mixed, d_mixed, d_logit,
d_gin and d_comp are float32. Every buffer starts on a 256-byte boundary.
"""

import pytest

from m2mixer_tpu_torch.ops import dynamixer_kernel as dk
from test_torch_mixer_bwd_plan import row_slices
from test_torch_mixer_fwd_plan import SMS, TC_BM, TC_BN, cdiv, wg_slices
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

THREADS, TILE_K = 256, 16
COL_SPLIT = 1024  # kColSplit
WG_BM, WG_BN = 128, 128


def pad8(n):
    return cdiv(n, 8) * 8


def col_plan(rows, cols, sms):
    """dynamixer.cu::col_plan: column-sum slices for eight CTAs an SM, at
    least kTileK rows a slice, at most kColSplit."""
    cs = min(cdiv(8 * sms, cdiv(cols, THREADS)), COL_SPLIT, cdiv(rows, TILE_K))
    size = cdiv(rows, cs)
    return size, cdiv(rows, size)


def dyna_plan(S, L, C, H, R, bf16, sms=SMS):
    """make_plan's slices and buffer sizes (bytes), or None for the shapes
    the kernels do not take (check_args)."""
    if min(S, L, C, H, R) < 1 or C % H or S * L > 64 * 65535 or S * H > 64 * 65535:
        return None
    rows, units, HR, LR, LL = S * L, S * H, H * R, L * R, L * L
    Cp, LRp, LLp, HRp = pad8(C), pad8(LR), pad8(LL), pad8(HR)
    if bf16:
        _, wsplit = wg_slices(rows, cdiv(C, WG_BM) * cdiv(C, WG_BN), sms, 1)
        _, vsplit = wg_slices(rows, cdiv(C, WG_BM) * cdiv(HR, 64), sms, 1)
        _, gsplit = wg_slices(units, cdiv(LL, WG_BM) * cdiv(LR, WG_BN), sms, 1)
    else:
        _, wsplit = row_slices(rows, cdiv(C, TC_BM) * cdiv(C, TC_BN), sms)
        _, gsplit = row_slices(units, cdiv(LL, TC_BM) * cdiv(LR, TC_BN), sms)
        vsplit = 0
    _, csplit = col_plan(rows, max(C, HR), sms)
    _, hsplit = col_plan(units, LL, sms)
    f, b = 4, 2
    if bf16:
        # the weights transposed (the 64-wide tile's B operands), and in the
        # backward also as they lie
        fwd = dict(xb=rows * Cp * b, wct=C * HRp * b, wgt=LR * LLp * b, wot=C * Cp * b,
                   gin=units * LRp * b, logits=units * LL * f, mixed=rows * Cp * b)
        bwd = dict(wcb=HR * Cp * b, wgb=LL * LRp * b, wob=C * Cp * b, gp=3 * rows * Cp * b,
                   dm=rows * Cp * b, dlog=units * LL * f,
                   dlp=3 * units * LLp * b, dcb=rows * HRp * b, dcomp=rows * HR * f,
                   p_wc=vsplit * C * HR * f)
    else:
        fwd = dict(comp=rows * HR * f, gin=units * LR * f, logits=units * LL * f,
                   mixed=rows * C * f)
        bwd = dict(dm=rows * C * f, dlog=units * LL * f, dgin=units * LR * f,
                   dcomp=rows * HR * f)
    bwd["p_wo"] = wsplit * C * C * f
    if not bf16:
        bwd["p_wc"] = wsplit * C * HR * f
    bwd.update(p_wg=gsplit * LL * LR * f, p_colg=hsplit * LL * f)
    bwd["p_col"] = csplit * (C + HR) * f
    whole = lambda n: cdiv(n, 256) * 256  # noqa: E731
    fwd_bytes = sum(whole(v) for v in fwd.values())
    return dict(Cp=Cp, LRp=LRp, LLp=LLp, HRp=HRp, wsplit=wsplit, vsplit=vsplit, gsplit=gsplit, csplit=csplit,
                hsplit=hsplit, sizes={**fwd, **bwd}, fwd_bytes=fwd_bytes,
                bwd_bytes=fwd_bytes + sum(whole(v) for v in bwd.values()))


def workspace_bytes(S, L, C, H, R, backward, bf16, sms=SMS):
    plan = dyna_plan(S, L, C, H, R, bf16, sms)
    return 0 if plan is None else plan["bwd_bytes" if backward else "fwd_bytes"]


class MirrorLib:
    @staticmethod
    def m2m_dyna_workspace_bytes(s, l, c, h, r, backward, bf16, dev):  # noqa: E741
        return workspace_bytes(s, l, c, h, r, backward, bf16)


CONFIG = dict(L=7, C=256, H=8, R=2)
LIFTED = {"l33": dict(L=33, C=1280, H=8, R=2), "l64": dict(L=64, C=512, H=4, R=3)}
# (S, L, C, H, R) -> (float32 forward, float32 backward, bf16 forward, bf16
# backward) bytes on 132 SMs
PLANS = {
    (7, 7, 256, 8, 2): (67_840, 422_400, 204_032, 767_232),
    (224, 7, 256, 8, 2): (2_157_568, 11_484_160, 2_155_264, 13_780_480),
    (3584, 7, 256, 8, 2): (34_521_088, 79_335_936, 32_368_384, 112_884_224),
    (4200, 7, 256, 8, 2): (40_454_400, 91_212_800, 37_907_456, 130_280_960),
    (2, 33, 1280, 8, 2): (416_512, 14_422_528, 3_872_768, 21_794_560),
    (64, 33, 1280, 8, 2): (13_314_048, 43_023_104, 16_580_096, 64_613_888),
    (2, 64, 512, 4, 3): (405_504, 6_136_320, 2_509_824, 10_806_784),
    (64, 64, 512, 4, 3): (12_976_128, 45_846_528, 14_794_752, 60_760_064),
}
CASES = sorted(PLANS)


@pytest.mark.parametrize("dims", CASES, ids=lambda d: "S{}-L{}-C{}-H{}-R{}".format(*d))
def test_workspace_matches_the_plan(dims):
    """The wrapper's workspace behind the mirror, pinned: float32 and bf16,
    forward and backward."""
    got = tuple(dk._workspace_bytes(MirrorLib, *dims, backward, bf16, 0)
                for bf16 in (False, True) for backward in (False, True))
    assert got == PLANS[dims]


FLOAT32_CASES = [(7 * B, *CONFIG.values()) for B in (1, 32, 512, 600)]
FLOAT32_CASES += [(64, *g.values()) for g in LIFTED.values()]


@pytest.mark.parametrize("dims", FLOAT32_CASES, ids=lambda d: "S{}-L{}-C{}-H{}-R{}".format(*d))
def test_float32_buffers_hold_the_intermediates(dims):
    """float32 runs the same products over all rows as bf16 at every shape:
    its workspace holds comp (S*L x H*R), gin (S*H x L*R), the logits and
    d_logit (S*H x L*L), mixed and d_mixed (S*L x C), d_gin and d_comp as
    float32, nothing a sequence at a time; the bias gradients' column sums
    take at most kColSplit slices."""
    S, L, C, H, R = dims
    p = dyna_plan(*dims, bf16=0)
    rows, units, f = S * L, S * H, 4
    z = p["sizes"]
    assert z["comp"] == z["dcomp"] == f * rows * H * R
    assert z["gin"] == z["dgin"] == f * units * L * R
    assert z["logits"] == z["dlog"] == f * units * L * L
    assert z["mixed"] == z["dm"] == f * rows * C
    assert 1 <= p["csplit"] <= COL_SPLIT and 1 <= p["hsplit"] <= COL_SPLIT


@pytest.mark.parametrize("dims", CASES, ids=lambda d: "S{}-L{}-C{}-H{}-R{}".format(*d))
def test_bf16_operands_are_bf16_rows_of_whole_16_byte_groups(dims):
    """The bf16 rows route's products read bf16 operands in rows padded to
    8 elements: x and mixed (S*L x Cp), gin (S*H x LRp), g's and d_logit's
    three planes; the logits and d_logit stay float32."""
    S, L, C, H, R = dims
    p = dyna_plan(*dims, bf16=1)
    assert all(v % 8 == 0 for v in (p["Cp"], p["LRp"], p["LLp"], p["HRp"]))
    z = p["sizes"]
    assert z["xb"] == z["mixed"] == 2 * S * L * p["Cp"]
    assert z["gp"] == 3 * z["xb"] and z["dlp"] == 3 * 2 * S * H * p["LLp"]
    assert z["logits"] == z["dlog"] == 4 * S * H * L * L


@pytest.mark.parametrize("dims", [(65536, 65, 4, 1, 1), (600000, 4, 8, 8, 1)],
                         ids=["rows_pass_the_grid", "units_pass_the_grid"])
def test_shapes_the_kernels_do_not_take_raise(dims):
    """No L or C cap: only rows beyond the products' grid (S*L or S*H above
    64 x 65535) are refused, with the shape in the message."""
    for bf16 in (False, True):
        with pytest.raises(ValueError, match=f"do not take S={dims[0]} L={dims[1]}"):
            dk._workspace_bytes(MirrorLib, *dims, True, bf16, 0)
