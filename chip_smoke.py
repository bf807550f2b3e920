"""Chip smoke test of the PyTorch/CUDA port (``m2mixer_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (any failure raises and exits non-zero; nothing is caught):

1. build the CUDA kernels from ``m2mixer_tpu_torch/ops/csrc`` (nvcc, sm_90a);
2. K1f ``fused_mixer_block`` on the card against its plain PyTorch version at
   the served shapes (B=512; N=4/C=3072 and N=8/C=3078), f32 and bf16, erf
   and tanh GELU;
3. K2f ``fused_mixer_stack``: a 4-block encoder with its final LN, whole and
   with ``group_size=2``, and the 2-block fusion mixer, the same way;
4. K1b / K2b, the backward kernels, against autograd of the plain versions
   with the same dropout masks: K1b at the encoder (N=4, C=3072) and fusion
   (N=8, C=3078) shapes, K2b as a 4-block encoder with its LN (``group_size``
   0 and 2); batch 32 and 512, erf and tanh, dropout 0 and 0.5; dx and every
   parameter gradient. Also: the forward at dropout 0.5 equals its plain
   version, the kept share is 0.5 +- 0.01, and two backward runs give
   bit-identical gradients;
5. serving: export the B config (``cfg/avmnist/avmnist_m2-mixer_B.yml``, full
   width and depth, seeded weights) through ``serving export --pallas`` (one
   stack kernel per mixer), and through ``to_torch_kernel_serving(...,
   per_block=True)`` + ``export_serving`` (one block kernel per MixerBlock, the
   ``PallasMLPMixer`` / ``PallasFusionMixer`` block types), load both with
   ``load_serving``, answer requests of 1, 7, 32,
   100 and 600 samples (600 is above the top bucket, 512), and hold every
   answer against the plain-module model on the card with the same weights.
   The kernels' launch counters are zeroed just before and read just after;
   each kernel must have launched;
6. training the B config (full width and depth) through both kernel block
   types: step 1 at ``model.dropout=0.0`` (loss, the three branch losses and
   every parameter gradient against the plain-module model with the same
   weights), then ``python -m m2mixer_tpu_torch.run`` (``run.main``) for 2
   epochs of 1024/256/256 learnable synthetic samples at batch 32 and the
   config's dropout 0.5, once with ``PallasStacked*`` (K2f/K2b) and once
   with ``PallasMLPMixer``/``PallasFusionMixer`` (K1f/K1b). Losses finite,
   the last epoch's train loss below the first's, val and test accuracy at
   least 0.2 (chance is 0.1). The launch counters are zeroed just before each
   run and read just after; K1b and K2b must have launched;
7. times (CUDA events, median of 5 runs): the kernels and their plain
   versions, the served forward at batch 32 and 512, the train step at batch
   32 and 512 for plain modules and both kernel block types;
8. one JSON line naming every ported kernel, the card's name and power limit,
   and the result line ``{"ok": true, "device": {...}}``.

Tolerances: float32 outputs within 1e-4 absolute (the kernel and cuBLAS sum
the same float32 products in different orders; no TF32 on either side).
bf16: both sides round to bf16 at the same points, so the kernel's outputs
lie on the bf16 grid and almost all of them equal the plain version's bit
for bit; a float32 sum taken in another order can land on the other side of
a rounding boundary (one bf16 ulp), and later blocks carry that. So at most
10% of the outputs may differ, none by more than 2e-2 of the output's max
magnitude. A max-error limit alone would not notice a kernel that skipped
the inner rounding points, so every bf16 case also runs a control: the plain
version in float32 with only its output rounded to bf16 must fail the same
check. Served logits within 2e-4 absolute. Gradients (K1b/K2b and the
training step): every tensor within 1e-4 x max(1, max|plain|) of the plain
version's (float32 sums of the same products in another order, over up to
C = 3078 hidden units or B*N = 4096 rows); a gradient that is exactly zero
in the math (the token FF's output bias under a following LayerNorm) is
float noise on both sides and must stay below 1e-3 on both.

The run writes its numbers to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_m2-mixer_B.yml")
# published H100 SXM peaks (dense): float32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
F32_ATOL = 1e-4
BF16_REL = 2e-2
BF16_MISMATCH = 0.10  # share of bf16 outputs allowed to differ from the plain version
SERVED_ATOL = 2e-4
REQUESTS = (1, 7, 32, 100, 600)
GRAD_REL = 1e-4
ZERO_GRAD = 1e-3  # below this everywhere, a gradient is float noise of an exact zero
MIN_ACC = 0.2  # chance is 0.1
TRAIN_SIZES = "[1024, 256, 256]"
KERNEL_BLOCKS = {
    "stacked": ["model.modalities.image.block_type=PallasStackedMLPMixer",
                "model.modalities.audio.block_type=PallasStackedMLPMixer",
                "model.modalities.multimodal.block_type=PallasStackedFusionMixer"],
    "per_block": ["model.modalities.image.block_type=PallasMLPMixer",
                  "model.modalities.audio.block_type=PallasMLPMixer",
                  "model.modalities.multimodal.block_type=PallasFusionMixer"],
}
ENC = dict(N=4, D=128, T=32, C=3072)
FUSION = dict(N=8, D=128, T=32, C=3078)


def rand_blocks(mk, torch, K, N, D, T, C, seed):
    """K blocks of parameters (JAX layout) at torch-default scales, LN
    params jittered away from the identity, on the card."""
    g = torch.Generator().manual_seed(seed)
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    ln = lambda: (1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g))
    blocks = []
    for _ in range(K):
        (s1, b1), (s2, b2) = ln(), ln()
        p = (s1, b1, u(N, N, T), u(N, T), u(T, T, N), u(T, N), s2, b2,
             u(D, D, C), u(D, C), u(C, C, D), u(C, D))
        blocks.append(mk.MixerBlockParams(*(t.cuda() for t in p)))
    s, b = ln()
    return blocks, s.cuda(), b.cuda()


def max_err(torch, got, want, what: str) -> float:
    """float32 check: max |err| within F32_ATOL."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    print(f"  {what}: max |err| {err:.3e} (tol {F32_ATOL:.0e})")
    if not err <= F32_ATOL:
        raise AssertionError(f"{what}: max |err| {err} > {F32_ATOL}")
    return err


def bf16_stats(torch, got, want):
    """(max |err|, its limit, share of outputs not bit-equal, all on the bf16 grid?)"""
    err = (got - want).abs().max().item()
    share = (got != want).float().mean().item()
    on_grid = bool((got == got.to(torch.bfloat16).float()).all())
    return err, BF16_REL * want.abs().max().item(), share, on_grid


def bf16_err(torch, got, want, control, what: str, report) -> float:
    """bf16 check (module docstring), and the proof that it separates: the
    ``control`` (float32 math, output rounded to bf16) must fail it."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, tol, share, on_grid = bf16_stats(torch, got, want)
    c_err, _, c_share, c_grid = bf16_stats(torch, control, want)
    print(f"  {what}: max |err| {err:.3e} (tol {tol:.3e}), outputs differing {share:.4f} "
          f"(tol {BF16_MISMATCH}); float32-math control: max |err| {c_err:.3e}, "
          f"differing {c_share:.4f}")
    report["bf16_checks"][what] = {"max_abs_err": err, "tol": tol, "share_differing": share,
                                   "control_max_abs_err": c_err,
                                   "control_share_differing": c_share}
    if not (on_grid and err <= tol and share <= BF16_MISMATCH):
        raise AssertionError(f"{what}: on bf16 grid {on_grid}, max |err| {err} (tol {tol}), "
                             f"share differing {share} (tol {BF16_MISMATCH})")
    if c_grid and c_err <= tol and c_share <= BF16_MISMATCH:
        raise AssertionError(f"{what}: the float32-math control passes the bf16 check, "
                             "so the check cannot see skipped rounding points")
    return err


def round_bf16(torch, t):
    return t.to(torch.bfloat16).float()


def cuda_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def grad_err(torch, got, want, what: str) -> float:
    """Gradient check: every tensor within GRAD_REL x max(1, max|plain|);
    returns the worst absolute error. A gradient that is exactly zero in the
    math (the token FF's output bias b2 under a following LayerNorm: a sum
    of B*D terms that cancel) is float noise on both sides, of ~1e-4 at
    batch 512; it passes when both sides stay below ZERO_GRAD everywhere."""
    worst, zeros = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: tensor {i} is not finite")
        scale = b.abs().max().item()
        tol = GRAD_REL * max(1.0, scale)
        err = (a - b).abs().max().item()
        if err <= tol:
            worst = max(worst, err)
        elif scale <= ZERO_GRAD and a.abs().max().item() <= ZERO_GRAD:
            zeros += 1
        else:
            raise AssertionError(f"{what}: tensor {i}: max |err| {err} > {tol}")
    note = f" ({zeros} zero up to noise on both sides)" if zeros else ""
    print(f"  {what}: worst |err| {worst:.3e} over {len(got)} tensors{note}")
    return worst


def plain_grouped(mk, x, blocks, s, b, seed, rate, group_size, approx):
    """The plain version of fused_mixer_stack_grouped (group seeds folded)."""
    k = len(blocks)
    if group_size <= 0 or group_size >= k:
        return mk.mixer_stack_reference(x, mk.stack_flat_params(blocks, s, b),
                                        approximate_gelu=approx, dropout_rate=rate, seed=seed)
    for gi, start in enumerate(range(0, k, group_size)):
        group = blocks[start:start + group_size]
        last = start + len(group) >= k
        flat = mk.stack_flat_params(group, s, b) if last else mk.stack_flat_params(group)
        x = mk.mixer_stack_reference(x, flat, final_ln=last, approximate_gelu=approx,
                                     dropout_rate=rate, seed=seed + 7919 * gi)
    return x


def block_work(B, N, D, T, C, wbytes):
    """(flops, parameter bytes) of one MixerBlock forward: w3/w4 are read at
    ``wbytes`` (the compute dtype's width, as the kernel reads them), every
    other parameter as float32."""
    flops = 4 * B * N * D * C + 4 * B * D * N * T
    param_bytes = wbytes * 2 * D * C + 4 * (2 * N * T + C + T + N + 5 * D)
    return flops, param_bytes


def bwd_work(B, N, D, T, C):
    """(flops, bytes) of one MixerBlock backward in float32: the dx and
    parameter-gradient products (a recompute is the kernel's choice, not
    required work); x, g and dx, the parameters read, the gradients written."""
    flops = 8 * B * N * D * C + 8 * B * D * N * T
    _, param_bytes = block_work(B, N, D, T, C, 4)
    return flops, 3 * B * N * D * 4 + 2 * param_bytes


def bound(flops: float, nbytes: float, dtype: str):
    """Least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch, mk, report):
    print("[2/8] K1f fused_mixer_block vs plain version")
    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        blocks, _, _ = rand_blocks(mk, torch, 1, seed=11, **geom)
        x = torch.randn(512, geom["N"], geom["D"], generator=torch.Generator().manual_seed(1)).cuda()
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for approx in (False, True):
                got = mk.fused_mixer_block(x, blocks[0], compute_dtype=cd, approximate_gelu=approx)
                want = mk.mixer_block_reference(x, blocks[0], compute_dtype=cd,
                                                approximate_gelu=approx)
                key = f"K1f/{geom_name}/{dtype}/{'tanh' if approx else 'erf'}"
                if dtype == "f32":
                    report["errors"][key] = max_err(torch, got, want, key)
                else:
                    control = mk.mixer_block_reference(x, blocks[0], approximate_gelu=approx)
                    report["errors"][key] = bf16_err(torch, got, want, round_bf16(torch, control),
                                                     key, report)

    print("[3/8] K2f fused_mixer_stack vs plain version")
    cases = [("encoder", ENC, 4, 0), ("encoder", ENC, 4, 2), ("fusion", FUSION, 2, 0)]
    for geom_name, geom, K, group in cases:
        blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=12, **geom)
        x = torch.randn(512, geom["N"], geom["D"], generator=torch.Generator().manual_seed(2)).cuda()
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for approx in (False, True):
                got = mk.fused_mixer_stack_grouped(x, blocks, ln_s, ln_b, compute_dtype=cd,
                                                   group_size=group, approximate_gelu=approx)
                flat = mk.stack_flat_params(blocks, ln_s, ln_b)
                want = mk.mixer_stack_reference(x, flat, compute_dtype=cd,
                                                approximate_gelu=approx)
                key = f"K2f/{geom_name}x{K}/g{group}/{dtype}/{'tanh' if approx else 'erf'}"
                if dtype == "f32":
                    report["errors"][key] = max_err(torch, got, want, key)
                else:
                    control = mk.mixer_stack_reference(x, flat, approximate_gelu=approx)
                    report["errors"][key] = bf16_err(torch, got, want, round_bf16(torch, control),
                                                     key, report)


def phase_backward(torch, mk, report):
    print("[4/8] K1b / K2b backward kernels vs autograd of the plain versions")
    for B in (32, 512):
        for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
            blocks, _, _ = rand_blocks(mk, torch, 1, seed=21, **geom)
            gen = torch.Generator().manual_seed(B)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for rate in (0.0, 0.5):
                for approx in (False, True):
                    key = f"K1b/{geom_name}/B{B}/rate{rate}/{'tanh' if approx else 'erf'}"
                    run = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], seed=7,
                                                           dropout_rate=rate,
                                                           approximate_gelu=approx)
                    dx, grads = run()
                    wdx, wgrads = mk.mixer_block_bwd_reference(x, g, blocks[0], rate,
                                                               approximate_gelu=approx, seed=7)
                    report["errors"][key] = grad_err(torch, (dx, *grads), (wdx, *wgrads), key)
                    dx2, grads2 = run()
                    if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                        raise AssertionError(f"{key}: two backward runs differ")
            key = f"K1f/{geom_name}/B{B}/rate0.5"
            report["errors"][key] = max_err(
                torch, mk.fused_mixer_block(x, blocks[0], seed=7, dropout_rate=0.5),
                mk.mixer_block_reference(x, blocks[0], 0.5, seed=7), key)
            share = (mk.dropout_mask(7, 0, 2, B * geom["N"], geom["C"], 0.5, "cuda") > 0)
            share = share.float().mean().item()
            print(f"  kept share of mask 2, {geom_name} B={B}: {share:.4f}")
            if not abs(share - 0.5) <= 0.01:
                raise AssertionError(f"kept share {share} is not 0.5 +- 0.01")
            report.setdefault("kept_share", {})[f"{geom_name}/B{B}"] = share
    for B in (32, 512):
        blocks, s, b = rand_blocks(mk, torch, 4, seed=22, **ENC)
        gen = torch.Generator().manual_seed(B + 1)
        x = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        g = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        for group in (0, 2):
            for rate in (0.0, 0.5):
                for approx in (False, True):
                    key = f"K2b/encoderx4/g{group}/B{B}/rate{rate}/{'tanh' if approx else 'erf'}"
                    leaves = [t.detach().requires_grad_() for blk in blocks for t in blk]
                    ls, lb = s.detach().requires_grad_(), b.detach().requires_grad_()
                    lblocks = [mk.MixerBlockParams(*leaves[i:i + 12]) for i in range(0, 48, 12)]
                    xx = x.detach().requires_grad_()

                    def run():
                        out = mk.fused_mixer_stack_grouped(xx, lblocks, ls, lb, seed=9,
                                                           dropout_rate=rate, group_size=group,
                                                           approximate_gelu=approx)
                        return out, torch.autograd.grad(out, [xx, *leaves, ls, lb], g)

                    out, got = run()
                    want_out = plain_grouped(mk, xx, lblocks, ls, lb, 9, rate, group, approx)
                    want = torch.autograd.grad(want_out, [xx, *leaves, ls, lb], g)
                    max_err(torch, out.detach(), want_out.detach(), key + " forward")
                    report["errors"][key] = grad_err(torch, got, want, key)
                    if not all(torch.equal(a, c) for a, c in zip(got, run()[1])):
                        raise AssertionError(f"{key}: two backward runs differ")


def train_args(tmp, name, flavor):
    return ["-c", B_CFG, "-n", name, f"train.tensorboard_path={tmp}", "train.epochs=2",
            "dataset.params.synthetic=true", "dataset.params.synthetic_learnable=true",
            f"dataset.params.synthetic_sizes={TRAIN_SIZES}", *KERNEL_BLOCKS.get(flavor, [])]


def kernel_task(serving, apply_overrides, load_cfg, flavor, extra=()):
    cfg = load_cfg(B_CFG)
    apply_overrides(cfg, [*KERNEL_BLOCKS.get(flavor, []), *extra], warn=False)
    return serving._build_task(cfg, device="cuda"), cfg


def zero_counters(mk):
    for fn in (mk.fused_mixer_block, mk.fused_mixer_stack, mk.fused_mixer_block_bwd,
               mk.fused_mixer_stack_bwd):
        fn.launches = 0


def counters(mk):
    return {"K1f": mk.fused_mixer_block.launches, "K2f": mk.fused_mixer_stack.launches,
            "K1b": mk.fused_mixer_block_bwd.launches, "K2b": mk.fused_mixer_stack_bwd.launches}


def phase_training(torch, mk, serving, run, apply_overrides, load_cfg, synthetic, np, report):
    print("[6/8] training the B config through the kernel block types")
    plain, cfg = kernel_task(serving, apply_overrides, load_cfg, "plain", ["model.dropout=0.0"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic(32, seed=3, learnable=True).items()}

    def step_one(task):
        task.network.train()
        task.network.zero_grad(set_to_none=True)
        loss, aux = task.step(batch, task.make_ctx(0, "train"), train=True)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in task.network.named_parameters()}
        return [loss.detach()] + [aux["losses"][k].detach() for k in task.loss_names], grads

    p_losses, p_grads = step_one(plain)
    for flavor in ("stacked", "per_block"):
        per_block = flavor == "per_block"
        kernel, _ = serving.to_torch_kernel_serving(cfg, plain.network.state_dict(), device="cuda",
                                                    per_block=per_block)
        before = counters(mk)
        k_losses, k_grads = step_one(kernel)
        if counters(mk) == before:
            raise AssertionError(f"step 1 ({flavor}) launched no kernel")
        want = serving.to_torch_kernel_serving(cfg, p_grads, device="cuda",
                                               per_block=per_block)[1]
        if set(want) != set(k_grads):
            raise AssertionError(f"{flavor}: gradient names differ")
        names = sorted(k_grads)
        key = f"train step 1/{flavor}: loss, branch losses"
        report["errors"][key] = grad_err(torch, k_losses, p_losses, key)
        key = f"train step 1/{flavor}: {len(names)} parameter gradients"
        report["errors"][key] = grad_err(torch, [k_grads[n] for n in names],
                                         [want[n].cuda() for n in names], key)
    del plain, kernel

    runs = report["training_runs"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for flavor in ("stacked", "per_block"):
            # the main path: counters zeroed just before, read just after
            zero_counters(mk)
            t0 = time.time()
            trainer = run.main(train_args(tmp, f"smoke_{flavor}", flavor))
            launches = counters(mk)
            seconds = time.time() - t0
            with open(os.path.join(trainer.logger.log_dir, "metrics.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            train = [ln for ln in lines if "train_loss" in ln]
            val = [ln for ln in lines if "val_loss" in ln]
            test = [ln for ln in lines if "test_loss" in ln][-1]
            result = {"launches": launches, "seconds": seconds,
                      "train_loss": [ln["train_loss"] for ln in train],
                      "val_loss": [ln["val_loss"] for ln in val],
                      "val_acc": [ln["val_acc"] for ln in val], "test_acc": test["test_acc"],
                      "test_loss": test["test_loss"]}
            runs[flavor] = result
            print(f"  {flavor}: {json.dumps(result)}")
            if not all(np.isfinite(v) for ln in lines for v in ln.values()):
                raise AssertionError(f"{flavor}: non-finite metrics")
            if not result["train_loss"][-1] < result["train_loss"][0]:
                raise AssertionError(f"{flavor}: train loss did not fall: {result['train_loss']}")
            if not (result["val_acc"][-1] >= MIN_ACC and result["test_acc"] >= MIN_ACC):
                raise AssertionError(f"{flavor}: accuracy below {MIN_ACC}: {result}")
            want = ("K2f", "K2b") if flavor == "stacked" else ("K1f", "K1b")
            for name in want:
                if launches[name] <= 0:
                    raise AssertionError(f"{name} was never launched on the training path")
    report["training_launches"] = {"K1b": runs["per_block"]["launches"]["K1b"],
                                   "K2b": runs["stacked"]["launches"]["K2b"]}


def phase_serving(torch, mk, serving, get_model, load_cfg, np, report):
    print("[5/8] serving the B config through the kernel blocks")
    cfg = load_cfg(B_CFG)
    seed = int(cfg.train.seed)
    plain = get_model(cfg.model.type)(cfg.model, device="cuda", seed=seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dirs = {"stacked": os.path.join(tmp, "stacked"),
                "per_block": os.path.join(tmp, "per_block")}
        serving.main(["export", "-c", B_CFG, "-o", dirs["stacked"], "--pallas"])
        per_block, _ = serving.to_torch_kernel_serving(cfg, plain.network.state_dict(),
                                                       device="cuda", per_block=True)
        serving.export_serving(per_block, cfg, dirs["per_block"])
        models = {k: serving.load_serving(d) for k, d in dirs.items()}
    for k, m in models.items():
        if m.meta["block_flavor"] != "kernel":
            raise AssertionError(f"{k} artifact is not kernel-backed: {m.meta['block_flavor']}")

    rng = np.random.RandomState(0)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    # the main path: counters zeroed just before, read just after
    mk.fused_mixer_block.launches = 0
    mk.fused_mixer_stack.launches = 0
    answers = {(k, n): m.predict(feats) for k, m in models.items() for n, feats in requests.items()}
    launches = {"K1f": mk.fused_mixer_block.launches, "K2f": mk.fused_mixer_stack.launches}
    print(f"  main-path launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    worst = 0.0
    for (k, n), got in answers.items():
        feats = {f: torch.from_numpy(v).cuda() for f, v in requests[n].items()}
        want = serving.serve_fn(plain)(feats)
        outs = [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                              want["branch_logits"]))
        for g, w in outs:
            w = w.float().cpu().numpy()
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"{k} n={n}: bad output {g.shape} vs {w.shape}")
            worst = max(worst, float(np.abs(g - w).max()))
        print(f"  {k} request of {n}: logits {got['logits'].shape}, worst |err| so far "
              f"{worst:.3e}")
    if not worst <= SERVED_ATOL:
        raise AssertionError(f"served logits differ from the plain model by {worst}")
    report["served_max_abs_err"] = worst
    report["main_path_launches"] = launches
    return plain, models


def phase_times(torch, mk, serving, np, plain, models, report):
    print("[7/8] times (CUDA events, median of 5 runs of 20 calls)")
    times = report["times_ms"]
    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        for B in (32, 512):
            K = 4 if geom_name == "encoder" else 2
            blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=13, **geom)
            flat = mk.stack_flat_params(blocks, ln_s, ln_b)
            x = torch.randn(B, geom["N"], geom["D"], generator=torch.Generator().manual_seed(3)).cuda()
            for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                tag = f"{geom_name}/B{B}/{dtype}"
                # weights stored as the kernel-backed modules store them
                nflat = mk.cast_params(flat, cd)
                block = mk.MixerBlockParams(*nflat[:12])
                times[f"K1f/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_block(
                    x, block, compute_dtype=cd))
                times[f"K1f_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_block_reference(
                    x, block, compute_dtype=cd))
                times[f"K2f/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_stack(
                    x, nflat, compute_dtype=cd))
                times[f"K2f_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_stack_reference(
                    x, nflat, compute_dtype=cd))
                flops, pbytes = block_work(B, **geom, wbytes=2 if dtype == "bf16" else 4)
                act = 2 * B * geom["N"] * geom["D"] * 4
                report["bounds_ms"][f"K1f/{tag}"] = bound(flops, pbytes + act, dtype)
                report["bounds_ms"][f"K2f/{tag}"] = bound(
                    K * flops, K * pbytes + 8 * geom["D"] + act, dtype)
                print(f"  {tag}: K1f {times[f'K1f/{tag}']:.4f} ms (plain "
                      f"{times[f'K1f_plain/{tag}']:.4f}, bound "
                      f"{report['bounds_ms'][f'K1f/{tag}'][0]:.4f}); K2f x{K} "
                      f"{times[f'K2f/{tag}']:.4f} ms (plain {times[f'K2f_plain/{tag}']:.4f}, "
                      f"bound {report['bounds_ms'][f'K2f/{tag}'][0]:.4f})")

    rng = np.random.RandomState(1)
    fwd = {"plain": serving.serve_fn(plain)}
    fwd.update({k: m.forward_device for k, m in models.items()})
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        for k, f in fwd.items():
            times[f"served/{k}/B{B}"] = cuda_ms(torch, lambda: f(feats))
        mk.fused_mixer_block.launches = mk.fused_mixer_stack.launches = 0
        models["stacked"].forward_device(feats)
        per_fwd = mk.fused_mixer_stack.launches
        mk.fused_mixer_block.launches = mk.fused_mixer_stack.launches = 0
        models["per_block"].forward_device(feats)
        report["launches_per_forward"] = {"K2f (stacked)": per_fwd,
                                          "K1f (per_block)": mk.fused_mixer_block.launches}
        print(f"  served forward B={B}: " + ", ".join(
            f"{k} {times[f'served/{k}/B{B}']:.4f} ms" for k in fwd))
    print(f"  launches per served forward: {report['launches_per_forward']}")


def phase_train_times(torch, mk, serving, Trainer, apply_overrides, load_cfg, synthetic, report):
    """Backward kernels alone (training config: dropout 0.5) and the train step."""
    times = report["times_ms"]
    for B in (32, 512):
        tag = f"encoder/B{B}"
        blocks, ln_s, ln_b = rand_blocks(mk, torch, 4, seed=23, **ENC)
        flat = mk.stack_flat_params(blocks, ln_s, ln_b)
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        g = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        times[f"K1b/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_block_bwd(
            x, g, blocks[0], seed=1, dropout_rate=0.5))
        times[f"K1b_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_block_bwd_reference(
            x, g, blocks[0], 0.5, seed=1))
        with torch.no_grad():
            _, saved = mk._stack_forward(x, flat, 1, 0.5, torch.float32, True, False, save=True)
        times[f"K2b/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_stack_bwd(
            x, g, flat, seed=1, dropout_rate=0.5, saved=saved))
        times[f"K2b_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_stack_bwd_reference(
            x, g, flat, 0.5, seed=1))
        flops, nbytes = bwd_work(B, **ENC)
        report["bounds_ms"][f"K1b/{tag}"] = bound(flops, nbytes, "f32")
        ln_bytes = 4 * 4 * ENC["D"]  # final LN scale and bias, read and their grads written
        report["bounds_ms"][f"K2b/{tag}"] = bound(
            4 * flops, 4 * (nbytes - 3 * B * ENC["N"] * ENC["D"] * 4)
            + 3 * B * ENC["N"] * ENC["D"] * 4 + ln_bytes, "f32")
        print(f"  {tag}: K1b {times[f'K1b/{tag}']:.4f} ms (plain {times[f'K1b_plain/{tag}']:.4f}, "
              f"bound {report['bounds_ms'][f'K1b/{tag}'][0]:.4f}); K2b x4 "
              f"{times[f'K2b/{tag}']:.4f} ms (plain {times[f'K2b_plain/{tag}']:.4f}, bound "
              f"{report['bounds_ms'][f'K2b/{tag}'][0]:.4f})")
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_steps_") as tmp:
        for flavor in ("plain", "stacked", "per_block"):
            task, cfg = kernel_task(serving, apply_overrides, load_cfg, flavor)
            trainer = Trainer(cfg.train, name=f"steps_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            for B in (32, 512):
                batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                times[f"train_step/{flavor}/B{B}"] = cuda_ms(
                    torch, lambda: trainer.train_step(task, batch, ctx), iters=10)
            trainer.logger.close()
            del task, trainer
    print("  train step (forward + backward + Adam, dropout 0.5): " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items() if k.startswith("train_step/")))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    import numpy as np

    from m2mixer_tpu_torch import run, serving
    from m2mixer_tpu_torch.config import apply_cli_overrides
    from m2mixer_tpu_torch.config import load as load_cfg
    from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
    from m2mixer_tpu_torch.models import get_model
    from m2mixer_tpu_torch.ops import _build
    from m2mixer_tpu_torch.ops import mixer_kernel as mk
    from m2mixer_tpu_torch.training.trainer import Trainer

    t_start = time.time()
    report = {"errors": {}, "bf16_checks": {}, "times_ms": {}, "bounds_ms": {}}
    print("[1/8] building the CUDA kernels")
    t0 = time.time()
    _build.build_library(verbose=True)
    _build.load_library()
    report["build_seconds"] = time.time() - t0
    print(f"  build seconds: {report['build_seconds']:.1f}")

    phase_kernels(torch, mk, report)
    phase_backward(torch, mk, report)
    plain, models = phase_serving(torch, mk, serving, get_model, load_cfg, np, report)
    phase_training(torch, mk, serving, run, apply_cli_overrides, load_cfg,
                   synthetic_avmnist_arrays, np, report)
    phase_times(torch, mk, serving, np, plain, models, report)
    phase_train_times(torch, mk, serving, Trainer, apply_cli_overrides, load_cfg,
                      synthetic_avmnist_arrays, report)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    report["card"] = card
    report["seconds"] = time.time() - t_start
    t = report["times_ms"]
    b1, by1 = report["bounds_ms"]["K1f/encoder/B512/f32"]
    b2, by2 = report["bounds_ms"]["K2f/encoder/B512/f32"]
    b3, by3 = report["bounds_ms"]["K1b/encoder/B512"]
    b4, by4 = report["bounds_ms"]["K2b/encoder/B512"]
    kernels = [
        {"name": "mixer_block_fwd (K1f, one MixerBlock, B=512 N=4 D=128 T=32 C=3072 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_fwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:213",
         "launches": report["main_path_launches"]["K1f"],
         "max_abs_err": report["errors"]["K1f/encoder/f32/erf"],
         "ms": t["K1f/encoder/B512/f32"], "plain_ms": t["K1f_plain/encoder/B512/f32"],
         "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "mixer_stack_fwd (K2f, 4 MixerBlocks + LN, B=512 N=4 D=128 T=32 C=3072 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_fwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:421",
         "launches": report["main_path_launches"]["K2f"],
         "max_abs_err": report["errors"]["K2f/encoderx4/g0/f32/erf"],
         "ms": t["K2f/encoder/B512/f32"], "plain_ms": t["K2f_plain/encoder/B512/f32"],
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
        {"name": "mixer_bwd (K1b, one MixerBlock backward, B=512 N=4 D=128 T=32 C=3072 f32, "
                 "dropout 0.5)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:267",
         "launches": report["training_launches"]["K1b"],
         "max_abs_err": report["errors"]["K1b/encoder/B512/rate0.5/erf"],
         "ms": t["K1b/encoder/B512"], "plain_ms": t["K1b_plain/encoder/B512"],
         "bound_ms": b3, "bound_by": by3, "library_ms": None},
        {"name": "mixer_bwd (K2b, 4 MixerBlocks + LN backward, B=512 N=4 D=128 T=32 C=3072 "
                 "f32, dropout 0.5)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:506",
         "launches": report["training_launches"]["K2b"],
         "max_abs_err": report["errors"]["K2b/encoderx4/g0/B512/rate0.5/erf"],
         "ms": t["K2b/encoder/B512"], "plain_ms": t["K2b_plain/encoder/B512"],
         "bound_ms": b4, "bound_by": by4, "library_ms": None},
    ]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, "kernels": kernels}, f, indent=2)
    print(f"[8/8] done in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
