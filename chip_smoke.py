"""Chip smoke test of the PyTorch/CUDA port (``m2mixer_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device
    python3 chip_smoke.py --kernel-times [--root DIR]
    python3 chip_smoke.py --ab PARENT_DIR

With no arguments it runs every phase below. ``--kernel-times`` only builds
and prints the times of all eight kernels: K1f, K2f, K1b and K2b (the
encoder and fusion stacks, float32 and bf16), K3f and K3b (encoder and
fusion shape, float32 and bf16; each bf16 call's launches in order and its
products summed), K4f and
K4b at batch 32 and 512, bf16 K1b and K2b at the L fusion shape at batch
512 (each launch of one call in launch order, and K1b's five channel
products summed), and bf16 K1f and K2f (the main path's depth) at the three
L shapes at batch 512 (each launch in order, and K1f's two channel products
summed); the device time of each launch of one K1f call at
each shape at batch 512 and of one K1b call at each shape and batch; the
host time to enqueue one K1b call and one bf16 K3f and K3b call; the B
config's served forward and train step at batch 32 and 512 (plain modules
and both kernel block types);
the L config's served forward at batch 32 and 512 (plain modules and the
``export --pallas`` network) and train step at 512 (both kernel block types);
and the bf16 gMLP config's served forward (plain modules and the ``export
--pallas`` network) and train step (kernel blocks) at 32 and 512; bf16 K4f
and K4b at 32 and 512 (at 512 each launch of one call in order, and their
engine products summed) and the bf16 DynaMixer config's served forward and
train step at 32 and 512,
as one JSON line (``--root``: those of the ``m2mixer_tpu_torch`` of another
checkout). ``--ab`` compares another checkout's numbers with this one's on
the same card, in turns (parent, this, this, parent), each in its own
process, into ``chiprun_out/kernel_ab.json``.

Phases (any failure raises and exits non-zero; nothing is caught):

1. build the CUDA kernels from ``m2mixer_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print every kernel's registers and spills (ptxas);
2. K1f ``fused_mixer_block`` on the card against its plain PyTorch version at
   the served shapes (N=4/C=3072 and N=8/C=3078): batch 512 in f32 and bf16,
   batch 32 and 600 (above the top bucket) in f32, erf and tanh GELU; each
   bf16 call's launches checked: its products on the wgmma engine (two
   ``wg_gemm_kernel`` a block, four on the token pipeline) and no
   ``tc_gemm_kernel``;
3. K2f ``fused_mixer_stack``: a 4-block encoder with its final LN, whole and
   with ``group_size=2``, and the 2-block fusion mixer, the same way;
4. K1b / K2b, the backward kernels, against autograd of the plain versions
   with the same dropout masks: K1b at the encoder (N=4, C=3072) and fusion
   (N=8, C=3078) shapes, K2b as a 4-block encoder with its LN (``group_size``
   0 and 2); batch 32 and 512, erf and tanh, dropout 0 and 0.5; dx and every
   parameter gradient. Also: the forward at dropout 0.5 equals its plain
   version, the kept share is 0.5 +- 0.01, and two backward runs give
   bit-identical gradients. Then the same cases in bf16 compute (float32
   parameters, w3/w4 read rounded to bf16): dx and
   every gradient against autograd of the plain bf16 version, each against
   a control (the float32 backward, rounded where the bf16 one rounds) that
   must fail the check; two runs bit-identical. Then K1f, K2f and K2b at the
   main path's depth (4 image, 4 audio, 2 fusion blocks + LN), and K1b, at
   the L config's three mixer shapes (N = 16, 64, 80; D 512, T 256, C 4096;
   tanh GELU), batch 32 (dropout 0.5) and 512, float32 and bf16: there every
   token FF runs as products (``token_ff.cuh``); the bf16 stacks held to the
   share of a second implementation (the plain version with float64 sums) +
   ``L_STACK_EXCESS``; each bf16 K1f/K2f call's launches checked as in 2;
5. K3f / K3b, the gMLP block kernels, against the plain version and its
   autograd at the gMLP config's shapes (D=128, F=768; encoder N=49, fusion
   N=99), batch 32 and 512, erf and tanh, dropout 0 and 0.5: the output, dx
   and the 10 parameter gradients. At dropout 0.5 the kernels and the plain
   version apply the same masks (so the forward's and the backward's
   agree), each of the three keeps 0.5 +- 0.01; two backward runs give
   bit-identical gradients. Then the same shapes in bf16 compute (float32
   parameters, rounded where JAX's ``_block_math`` casts them), erf, dropout
   0 and 0.1: the output by the bf16 check below, dx and the 10 gradients by
   the bf16 gradient check (all but b_in, sgu_b and b_out rounded; the plain
   bf16 version on the CPU beside at batch 32), each with its float32-math
   control; two backward runs bit-identical; each bf16 call's launches
   checked by the library's tallies: K3f's two products and K3b's five as
   ``wg_gemm_kernel`` (the wgmma engine), no ``tc_gemm_kernel``. Then the
   block at F = 4096 (N=49, D=128, batch 32, dropout 0.1; LN(v)'s rows on a
   row tile sized from the shared memory) in float32 and bf16 the same way.
   (At the end of 4: K1f, K2f (4 blocks + LN), K1b and K2b at hidden widths
   the kernels pad, D = 20 and 30 at the B shapes' N, T and C, batch 64,
   dropout 0.5, float32 and bf16, by the checks above; and at the MIMIC H
   fusion mixer's shape, N 25, D 64, T 8, C 64, batch 128 and 512, dropout
   0.3: float32 with erf, bf16 with tanh, each bf16 call's products on the
   wgmma engine by the tallies). Then K3f / K3b above 128 tokens, the large-N
   route (N = 129 and 196 at D 128, F 768, and 196 at F 4096; batch 32,
   dropout 0.1; float32 and bf16 by the checks above), the launch tallies
   showing one ``gmlp_vt_kernel`` and three (K3f) or eight (K3b) products of
   the dtype's engine a call above 128 tokens, and the shared-memory SGU at
   128;
6. K4f / K4b, the DynaMixerOp kernels, against the plain version and its
   autograd at the DynaMixer config's op (L=7, C=256, H=8, R=2; S = 7 x 32
   and 7 x 512 sequences; the weights output-major, as ``DynaMixerOp``
   hands them over), x as drawn and scaled by 30 (generate logits of
   about 50: the softmax's stress case): the output, dx and the 6 parameter
   gradients; two backward runs give bit-identical gradients. Then the same
   in bf16 compute (float32 parameters): the output within 1.5e-3 x max(1,
   max|plain bf16|), dx and the gradients by the bf16 gradient check (dW_c,
   dW_g, dW_o rounded), each with its float32-math control, every bf16 call's
   products counted by the library's tallies (three ``wg_gemm_kernel`` a
   K4f, eight a K4b, no ``tc_gemm_kernel``; so too over the bf16 training
   and serving runs of 12); both dtypes also at the lifted shapes, whose
   sequence would outgrow a CTA's shared memory (L=33 C=1280 H=8 R=2 and
   L=64 C=512 H=4 R=3, 64 sequences; bf16 x as drawn and x30, the
   float32-math control asserted at x30). Then the
   3xTF32 error against rows: K1b (encoder and fusion shape), K3b (encoder
   shape) and K4b at batch 2048 and 4096, and K1b at the L audio and fusion
   shapes at batch 512 (the token weight gradients sum B*D = 262144 rows),
   against autograd of their plain versions on the card, each tensor's error
   relative to max(1, max|plain|) beside the rows of the slices the plan
   sums the weight gradients over; and the bf16 wgmma engine's products
   alone (``m2m_wg_product``) at the L fusion shape, batch 512: K1b's five
   channel products (da3 as three bf16 planes) and K1f's four (the channel
   FF's up and down, the token FF's up and down), and at the gMLP fusion
   shape, batch 512, bf16 K3f's and K3b's six (the in- and out-projection,
   dgated, dxn and dW_in with dpre as three bf16 planes, dW_out), and at the
   DynaMixer config's op, batch 512, bf16 K4f's three and K4b's six (g and
   d_logit as three bf16 planes), each against the float64 product of the
   same values, relative to its largest magnitude;
7. serving: export the B config (``cfg/avmnist/avmnist_m2-mixer_B.yml``, full
   width and depth, seeded weights) through ``serving export --pallas`` (one
   stack kernel per mixer), and through ``to_torch_kernel_serving(...,
   per_block=True)`` + ``export_serving`` (one block kernel per MixerBlock, the
   ``PallasMLPMixer`` / ``PallasFusionMixer`` block types), load both with
   ``load_serving``, answer requests of 1, 7, 32,
   100 and 600 samples (600 is above the top bucket, 512), and hold every
   answer against the plain-module model on the card with the same weights.
   The kernels' launch counters are zeroed just before and read just after;
   each kernel must have launched;
8. serving the gMLP config (``cfg/avmnist/avmnist_gmlp.yml``, full width and
   depth: 30 + 30 + 15 blocks, seeded weights): ``serving export`` of the
   plain artifact, then ``serving export --pallas -p`` its weights (K3f per
   block); requests of 1, 7, 32, 100 and 600 samples against the plain
   artifact on the card; the K3f counter zeroed just before, read just after;
9. serving the DynaMixer config (``cfg/avmnist/avmnist_3loss_dyna.yml``, full
   width and depth: 8 + 8 + 4 blocks at hidden 256, seeded weights):
   ``serving export``, then ``load_serving`` on the card (every DynaMixerOp
   launches K4f) and on the CPU (the plain versions; a plain path on the card
   would be a fallback); requests of 1, 7, 32, 100 and 600 samples against
   the CPU; the K4f counter zeroed just before, read just after: 40 a device
   forward;
10. training the B config (full width and depth) through both kernel block
   types: step 1 at ``model.dropout=0.0`` (loss, the three branch losses and
   every parameter gradient against the plain-module model with the same
   weights), then ``python -m m2mixer_tpu_torch.run`` (``run.main``) for 2
   epochs of 1024/256/256 learnable synthetic samples at batch 32 and the
   config's dropout 0.5, once with ``PallasStacked*`` (K2f/K2b) and once
   with ``PallasMLPMixer``/``PallasFusionMixer`` (K1f/K1b). Losses finite,
   the last epoch's train loss below the first's, val and test accuracy at
   least 0.2 (chance is 0.1). The launch counters are zeroed just before each
   run and read just after; K1b and K2b must have launched;
11. training the gMLP config: step 1 with stochastic depth pinned off
   (``prob_0_L=[1.0, 1.0]`` on the three stacks) through
   ``PallasVisiongMLP``/``PallasFusiongMLP`` against the plain modules with
   the same weights (the loss, the branch losses, every gradient); then
   ``run.main`` for 2 epochs of 1024/256/256 learnable synthetic samples at
   batch 32 with the unchanged config (dropout 0, stochastic depth on), once
   with the plain modules and once with the kernel blocks: losses finite,
   train loss falling, val and test accuracy at least 0.5; K3f and K3b launched in
   the kernel run (counters zeroed just before, read just after) and no
   gMLP kernel in the plain one. Then the same config at
   ``model.precision=bf16``: step 1 through the kernel blocks (dropout 0,
   stochastic depth pinned off) on the card against the CPU at batch 32,
   the losses and every gradient within 2e-2 x max(1, max|CPU|); 2-epoch
   runs with the plain bf16 modules and with the kernel blocks (bf16 K3f/K3b
   counted in ``bf16_launches``), the kernel run's val and test accuracy at
   least 0.5, or, where the plain bf16 run misses 0.5 too, at least the plain
   run's - 0.1; the plain run's weights through ``serving export --pallas``
   (bf16 K3f, counter zeroed just before, read just after), requests of 1,
   7, 32 and 100 samples on the card against the same artifact on the CPU
   within 2e-2 x max(1, max|CPU|); in the bf16 step, the kernel run and the
   serving the library's tallies show every K3f/K3b product on the wgmma
   engine (two ``wg_gemm_kernel`` a K3f call, five a K3b call) and no
   ``tc_gemm_kernel``;
    Then the MIMIC H config (``cfg/mimic/mimic_m2-mixer_H.yml``, full width:
    static MLP 5 -> 64 -> 64 -> 64, time mixer 24 tokens 12 -> 64, fusion mixer
    N 25, D 64, T 8, C 64) on a ``gen_mimic`` surrogate ``im.pk`` (2000 stays:
    1600 train, 200 val, 200 test) written under a temporary directory:
    2-epoch ``run.main`` runs with the plain modules and with the fusion
    mixer on ``PallasStackedFusionMixer`` (K2f/K2b) and ``PallasFusionMixer``
    (K1f/K1b), in float32 as shipped and in bf16 with bench.py's levers
    (precision bf16, tanh GELU, bits dropout, bf16 Adam moment): losses
    finite and falling, val and test accuracy at least 1/3, twice chance
    (the plain float32 run of the same length reached 0.63 on the CPU),
    the kernels counted (zeroed just before, read just after), none in the
    plain runs; ``serving export --pallas`` of each plain run's best weights
    (K2f), requests of 1-600 samples, float32 within 2e-4 of the plain
    forward on the card, bf16 within 2e-2 x max(1, max|CPU|) of the same
    artifact on the CPU; one accumulated update (``train.grad_accum_steps=4``,
    micro-batch 32, dropout 0, stacked kernel blocks) on the card against the
    same update on the CPU (losses 1e-5 relative, the averaged gradients 1e-4
    x max(1, max|CPU|)). Then the gMLP config with the audio encoder at patch
    8 (196 tokens; 246 in the fusion stack), depth cut to 2 + 2 + 2, through
    the kernel blocks in float32 and bf16: a training step on the card
    against the CPU (1e-4 / 2e-2 x max(1, max|CPU|)) and a served forward,
    the large-N route counted by the tallies (one ``gmlp_vt_kernel`` a K3f
    and a K3b call above 128 tokens);
12. training the DynaMixer config: step 1 at ``model.dropout=0.0`` on the card
    against the same step on the CPU with the same weights and batch (the
    loss and the branch losses within 1e-5 relative, every gradient within
    1e-4 x max(1, max|CPU|)); then ``run.main`` of the unchanged config
    (dropout 0.5, Adam at lr 1e-4) for 5 epochs of 1024/256/256 learnable
    synthetic samples at batch 32 (it learns from the third): losses finite,
    train loss falling, val and test accuracy at least 0.2; K4f and K4b
    launched (counters zeroed just before, read just after); the same run at
    ``model.precision=bf16`` (bf16 K4f/K4b in every DynaMixerOp, counted in
    ``bf16_launches``), its weights exported and served on the card (bf16
    K4f, 40 a device forward) against the same artifact on the CPU within
    2e-2 x max(1, max|CPU|). Then the bf16
   recipe B_turbo (``cfg/avmnist/avmnist_m2-mixer_B_turbo.yml``, full width
   and depth: bf16, tanh GELU, bits dropout, paired encoders, Adam with a
   bf16 first moment) on path (a), as shipped (a ``PairedMLPMixer`` and the
   plain ``FusionMixer``, no kernel), and path (b), both kernel block types
   (bf16 K2f/K2b, K1f/K1b): step 1 at ``model.dropout=0.0`` on the card
   against the same network on the CPU (where every kernel wrapper takes its
   plain version), the losses and every gradient within 2e-2 x max(1,
   max|CPU|); then ``run.main`` for 2 epochs of 1024/256/256 learnable
   synthetic samples at batch 32 and the config's dropout 0.5 per path:
   losses finite, train loss falling, val and test accuracy at least 0.2;
   the bf16 K1b/K2b counters zeroed just before each run and read just
   after, non-zero on (b), every mixer counter zero on (a). Path (c):
   ``serving export --pallas`` of path (a)'s best weights (the paired
   encoders un-paired into per-modality bf16 K2f stacks), requests of 1, 7,
   32, 100 and 600 samples against the paired network on the card, the K2f
   counter zeroed just before and read just after. Then the L config
   (``cfg/avmnist/avmnist_m2-mixer_L.yml`` as shipped, full width and depth,
   42.4M parameters): step 1 at dropout 0 and batch 4 on the card against
   the CPU through ``PallasStacked*`` and ``Pallas*`` (2e-2 x max(1,
   max|CPU|)); 2-epoch ``run.main`` runs of 2048/512/512 samples at batch 512
   as shipped (plain modules) and with each kernel block type (losses finite
   and falling; K2f/K2b or K1f/K1b launched, their token pipeline counted in
   ``token_ff_launches``); ``serving export --pallas`` of the plain run's
   weights, requests of 1-600 samples on the card against the same artifact
   on the CPU (JAX's kernel math) within 2e-2 x max(1, max|CPU|), beside the
   plain bf16 and the float32 network's answers;
13. times (CUDA events, median of 5 runs): the mixer kernels and their plain
    versions (K1f, K2f, K1b and K2b at the encoder and fusion shapes, with
    their float32 and 3xTF32 bounds; bf16 K1f and K2f with their bf16-peak
    and design bounds), the served B forward at batch 32 and
    512, the B train step at batch 32 and 512 for plain modules and both
    kernel block types; and the device time of each launch of one K1f and
    one K1b call at batch 512 at both shapes (``torch.profiler``);
14. gMLP times: K3f and K3b alone at the encoder and fusion shapes at batch
    32 and 512 (with their plain versions, their float32 and 3xTF32 bounds,
    and the profiler's breakdown of one call of each at both shapes, batch
    512), the served forward and the train step at batch 32 and 512, plain
    modules and kernel blocks; then the same in bf16 compute (bf16 K3f / K3b
    with their plain bf16 versions, their bound at the dense bf16 peak and
    the design's, ``bf16_gmlp_design_ms``; the bf16 served forward and train
    step, plain modules and kernel blocks);
15. DynaMixer times: K4f and K4b alone at batch 32 and 512 (S = 224 and 3584)
    with their plain versions, float32 and 3xTF32 bounds and the profiler's
    breakdown of one K4f and one K4b call at batch 512, the served forward
    and the train step at batch 32 and 512, each with the device time its
    kernels take (``torch.profiler``), so the share of the call in which the
    card is busy; then each product of K1b, K3f, K3b, K4f and K4b at batch 512
    timed as one ``torch.matmul`` in float32 (TF32 off), a yardstick per
    product that the port never calls, K1b's also as one bf16
    ``torch.matmul``, and the bf16 K1f's four at the L shapes and bf16 K3f's
    and K3b's six at both gMLP shapes as one bf16 ``torch.matmul`` each; then
    the bf16 K1b and K2b alone at the encoder and
    fusion shapes at batch 32 and 512 with their plain versions, their
    bound at the dense bf16 peak and their design bound (the wgmma engine's
    nine bf16 passes and the token FF's products at their rate), each K2b
    call's launches checked to run the channel products on the engine (three
    ``wg_gemm_kernel`` launches a block, ``tc_gemm_kernel`` only for the
    token FF), and the B_turbo
    served forward and train step at batch 32 and 512 on paths (a) and (b);
    then the routes this slice added: K1f, K2f, K1b and K2b at the three L
    shapes, batch 32 and 512, float32 and bf16, with their plain versions,
    bounds and tensor-core bounds (in bf16 the design bounds:
    ``bf16_fwd_design_ms``, ``bf16_bwd_design_ms``), the
    profiler's breakdown at the fusion shape, batch 512, and at batch 512 in
    bf16 the engine check of K2b's and K1f's launches, the device time of
    bf16 K1b's five channel products and of each launch of one bf16 K1f
    call, its two channel products summed; bf16 K4f and K4b; the L served forward
    and train step (plain, stacked, per-block) and the bf16 DynaMixer
    served forward, batch 32 and 512;
    Then this slice's: K1f, K2f, K1b and K2b at the MIMIC fusion shape (batch
    128 and 512, float32 and bf16) with their plain versions and bounds; the
    MIMIC H train step and served forward (plain, per-block, stacked;
    float32 and bf16 levers; batch 128 and 512); K3f / K3b on the large-N
    route at 196 tokens (batch 32 and 512, float32 and bf16) with their
    plain versions, bounds and the SGU's token product as one
    ``torch.matmul`` in the compute dtype (``library_ms``);
16. one JSON line naming every ported kernel (the bf16 K4f/K4b, the bf16
    K3f/K3b and the token-pipeline K1f/K2f/K1b/K2b at the L fusion shape
    among them), the
    card's name and power limit, and the result line ``{"ok": true,
    "device": {...}}``.

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
float noise on both sides and must stay below 1e-3 on both. The gMLP path's
checks are relative to the plain version's magnitude, every tensor (output,
logits, gradient) within 1e-4 x max(1, max|plain|) (served logits 2e-4 x),
none exempt: the token projection starts at bias 1, so magnitudes grow with
width and depth, and no gMLP gradient is exactly zero in the math. The
DynaMixer path's checks are relative the same way (the card against the CPU
for the served logits and the train step). bf16 gradients: each tensor
within 2e-2 x max(1, max|plain|); those a cast rounds on the bf16 grid, and
of all their elements taken together at most 10% (K1b) or 40% (K2b, 4
blocks + LN) differing from the plain version's: a sum over upstream values
that each may sit one ulp off rounds to the other neighbour now and then,
and through a stack that compounds (two plain versions, cuBLAS on the card
and the CPU, differ in about a fifth of the stack's rounded elements; the
float32-math control in about four fifths, and must fail). B_turbo's served
logits within 5e-2 of the plain paired network's max magnitude (the paired
chain keeps its LayerNorm statistics in bf16, the kernels in float32); the
L config's kernel artifact within 2e-2 x max(1, max|CPU|) of the same
artifact on the CPU (the comment at its check says why not of the plain
modules).

The run writes its numbers to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
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
# the gMLP and DynaMixer kernels' products run as 3xTF32 on the tensor cores:
# three TF32 products each, so at best a third of the dense TF32 peak (495 TFLOP/s)
TC_3XTF32 = 495e12 / 3
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
GMLP_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_gmlp.yml")
GMLP_ENC = dict(N=49, D=128, F=768)  # avmnist_gmlp.yml: 49 patches a modality
GMLP_FUSION = dict(N=99, D=128, F=768)  # 98 fused tokens + the cls token
GMLP_KERNEL_BLOCKS = ["model.modalities.image.block_type=PallasVisiongMLP",
                      "model.modalities.audio.block_type=PallasVisiongMLP",
                      "model.modalities.multimodal.block_type=PallasFusiongMLP"]
# stochastic depth pinned off on all three stacks (the JAX gMLP lockstep's pin)
GMLP_NO_DEPTH_DROP = [f"model.modalities.{k}.prob_0_L=[1.0, 1.0]"
                      for k in ("image", "audio", "multimodal")]
SERVED_REL = 2e-4
# val accuracy after 2 epochs, chance + 0.4: the plain-module run of the same
# length reached 1.0 and the kernel-block run 0.906 (H100, PERF.md)
GMLP_MIN_ACC = 0.5
DYNA_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_3loss_dyna.yml")
DYNA_OP = dict(L=7, C=256, H=8, R=2)  # the config's op: rows or columns of a 7 x 7 grid
# the lifted shapes, whose sequence (x, W_g) would outgrow a CTA's shared
# memory, DYNA_LIFTED_S sequences each
DYNA_LIFTED = {"l33": dict(L=33, C=1280, H=8, R=2), "l64": dict(L=64, C=512, H=4, R=3)}
DYNA_LIFTED_S = 64
DYNA_OPS_PER_FORWARD = 40  # mix_h and mix_w in each of the 8 + 8 + 4 DynaMixerBlocks
LOSS_REL = 1e-5  # card against CPU: the loss and the branch losses
# the unchanged DynaMixer config (dropout 0.5 after every block, no residual,
# Adam at lr 1e-4) stays on its initial plateau for two epochs of 1024 learnable
# samples (val accuracy 0.05, 0.05) and learns from the third (0.34, 0.38, 0.68
# by the fifth; H100, PERF.md), so its run takes five epochs
DYNA_EPOCHS = 5
ROWS_BATCHES = (2048, 4096)  # the 3xTF32 error against the weight gradients' row count


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


def bf16_err(torch, got, want, control, what: str, report, second=None,
             limit=BF16_MISMATCH, excess=None) -> float:
    """bf16 check (module docstring), and the proof that it separates: the
    ``control`` (float32 math, output rounded to bf16) must fail it.
    ``second``: another correct implementation of the same casts (the plain
    version with float64 sums, ``float64_sums``), whose share differing from
    the plain version is reported as the floor of this check; with
    ``excess``, the share limit is that floor + ``excess``."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, tol, share, on_grid = bf16_stats(torch, got, want)
    c_err, _, c_share, c_grid = bf16_stats(torch, control, want)
    floor = None if second is None else bf16_stats(torch, second, want)[2]
    if excess is not None:
        limit = floor + excess
    note = "" if floor is None else f"; the plain version with float64 sums {floor:.4f}"
    print(f"  {what}: max |err| {err:.3e} (tol {tol:.3e}), outputs differing {share:.4f} "
          f"(tol {limit}{note}); float32-math control: max |err| {c_err:.3e}, "
          f"differing {c_share:.4f}")
    report["bf16_checks"][what] = {"max_abs_err": err, "tol": tol, "share_differing": share,
                                   "share_limit": limit, "float64_sums_share_differing": floor,
                                   "control_max_abs_err": c_err,
                                   "control_share_differing": c_share}
    if not (on_grid and err <= tol and share <= limit):
        raise AssertionError(f"{what}: on bf16 grid {on_grid}, max |err| {err} (tol {tol}), "
                             f"share differing {share} (tol {limit})")
    if c_grid and c_err <= tol and c_share <= limit:
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


def kernel_breakdown(torch, fn, what, calls: int = 10) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches
    (``torch.profiler``, ``calls`` calls after a warm-up): {name: [us per
    call, launches per call]}, printed largest first unless ``what`` is None.
    The trace can lose a kernel's first event in the window, so a kernel's
    time per call is its mean time a launch times its launches per call (its
    event count over ``calls``, rounded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = kernel_name(e.key)
            us, n = totals.get(name, (0.0, 0))
            totals[name] = (us + e.device_time_total, n + e.count)
    rows = {}
    for name, (us, n) in totals.items():
        per_call = max(1, round(n / calls))
        rows[name] = [us / n * per_call, per_call]
    if what is not None:
        print(f"  {what}, device us per call by kernel:")
        for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
            print(f"    {us:9.1f} us  x{n:g}  {name}")
    return rows


def kernel_name(key: str) -> str:
    """A profiler kernel key, "void (anonymous namespace)::f<...>(args)" -> "f<...>"."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def launch_sequence(torch, fn, calls: int = 3) -> list:
    """[[kernel, device us], ...] of one call of ``fn`` in launch order
    (``torch.profiler``'s kernel events): the last of ``calls`` calls after a
    warm-up, since the trace can lose the window's first event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    per_call = round(len(events) / calls)
    return [[kernel_name(e.name), e.time_range.elapsed_us()] for e in events[-per_call:]]


def launch_counts(torch, fn) -> dict:
    """{kernel: launches} of one call of ``fn`` for the kernels the library
    tallies on the host where it enqueues them (``_build.launch_tally``: the
    wgmma engine's, tc_gemm's and tok_in_kernel): exact, where a profiler
    trace may drop events."""
    return tallied(torch, fn)[1]


def tallied(torch, fn):
    """(``fn()``, its launch_counts): the result of a call with the launches
    of the kernels the library tallies on the host during it."""
    from m2mixer_tpu_torch.ops import _build

    before = _build.launch_tally()
    out = fn()
    torch.cuda.synchronize()
    after = _build.launch_tally()
    return out, {name: after[name] - before[name] for name in after}


def channel_products(seq) -> list:
    """The channel FF's five products among one bf16 K1b call's launches (in
    order): the wgmma engine's (``wg_gemm_kernel``: a3 and dh2 in one launch,
    dz, dW3 with dW4^T), or, on a tree from before the engine, the tc_gemm
    launches of a3 and dh2 (named by their epilogues), the one after them (dz)
    and the last two (dW3, dW4)."""
    wg = [row for row in seq if row[0].startswith("wg_gemm_kernel")]
    if wg:
        return wg
    tc = [row for row in seq if row[0].startswith("tc_gemm_kernel")]
    i = next(k for k, row in enumerate(tc) if "EpiChannelBwd" in row[0])
    return [tc[k] for k in (i - 1, i, i + 1, len(tc) - 2, len(tc) - 1)]


def check_engine_route(counts, what: str, blocks: int = 1) -> None:
    """A bf16 K1b/K2b call (``counts``: launch_counts) ran its channel
    products on the wgmma engine: three ``wg_gemm_kernel`` launches a block,
    and ``tc_gemm_kernel`` only for the token FF's products (six a block on
    the token pipeline, none on the register route)."""
    wg, tc = counts["wg_gemm_kernel"], counts["tc_gemm_kernel"]
    token = counts["tok_in_kernel"] > 0
    if wg != 3 * blocks or tc != (6 * blocks if token else 0):
        raise AssertionError(f"{what}: {wg} wgmma-engine and {tc} tc_gemm launches for "
                             f"{blocks} block(s) ({'token pipeline' if token else 'registers'})")
    print(f"  {what}: channel products on the wgmma engine ({wg} launches; tc_gemm {tc}, the "
          "token FF's)")


def check_fwd_engine_route(counts, what: str, blocks: int = 1) -> None:
    """A bf16 K1f/K2f call (``counts``: launch_counts) ran every product on
    the wgmma engine: two ``wg_gemm_kernel`` launches a block (the channel
    FF's up and down products), four on the token pipeline (the token FF's
    two as well), and no ``tc_gemm_kernel``."""
    wg, tc = counts["wg_gemm_kernel"], counts["tc_gemm_kernel"]
    token = counts["tok_in_kernel"] > 0
    if wg != (4 if token else 2) * blocks or tc:
        raise AssertionError(f"{what}: {wg} wgmma-engine and {tc} tc_gemm launches for "
                             f"{blocks} block(s) ({'token pipeline' if token else 'registers'})")
    print(f"  {what}: every product on the wgmma engine ({wg} launches, "
          f"{'token pipeline' if token else 'token FF in registers'}; no tc_gemm)")


# a bf16 call's products on the wgmma engine: K3f's in- and out-projection;
# K3b's in-projection, dgated, dxn, dW_in and dW_out; K4f's compress, generate
# and output products; K4b's two recomputed, d_mixed, d_gin, dx's compress
# part, dW_c, dW_g and dW_o
WG_LAUNCHES = {"K3f": 2, "K3b": 5, "K4f": 3, "K4b": 8}


def check_wg_route(counts, what: str, calls: dict) -> None:
    """bf16 K3f/K3b/K4f/K4b calls (``calls``: {"K3f": n, ...}; ``counts``:
    the library's launch tallies over them) ran every product on the wgmma
    engine: WG_LAUNCHES ``wg_gemm_kernel`` launches a call and no
    ``tc_gemm_kernel``."""
    wg, tc = counts["wg_gemm_kernel"], counts["tc_gemm_kernel"]
    want = sum(WG_LAUNCHES[k] * n for k, n in calls.items())
    if wg != want or tc:
        raise AssertionError(f"{what}: {wg} wgmma-engine launches (want {want}) and {tc} "
                             f"tc_gemm launches for {calls}")
    print(f"  {what}: every product on the wgmma engine ({wg} launches for {calls}; no "
          "tc_gemm)")


def product_launches(seq) -> list:
    """The products among one call's launches (in order): the wgmma engine's,
    or tc_gemm's in a tree from before it (a gMLP call's D x F and F/2 x D
    products, a DynaMixerOp's)."""
    return [row for row in seq if row[0].startswith(("wg_gemm_kernel", "tc_gemm_kernel"))]


def fwd_channel_products(rows) -> list:
    """[[kernel, device us per call], ...] of the channel FF's two products
    of a K1f call, from its kernel_breakdown rows (every kernel over several
    calls, so a trace that loses an event still finds both): the up product
    (its epilogue EpiUpWg on the wgmma engine, EpiUp on tc_gemm in a tree
    from before it) and the down product (the engine's EpiWgStore, tc_gemm's
    EpiNone)."""
    return [[name, us] for name, (us, _) in rows.items()
            if "EpiUp" in name or "EpiWgStore" in name or
            (name.startswith("tc_gemm_kernel") and "EpiNone" in name)]


def bf16_fwd_design_ms(B, N, D, T, C, token_products: bool) -> float:
    """The bf16 K1f design's bound (ms) of one block: each product on the
    wgmma engine at the larger of its flops at the dense bf16 peak and its
    bytes at HBM rate (bf16 operands, each read once, its output written
    once): the channel FF's up (h2 in bf16) and down (float32 sums) products,
    2*B*N*D*C flops each, and on the token pipeline the token FF's two,
    2*B*D*N*T each (ht bf16, tt float32); on the register route the token FF
    runs on the float32 CUDA cores (4*B*D*N*T flops)."""
    def product(flops, nbytes):
        return max(flops / PEAK["bf16"], nbytes / HBM_BYTES_PER_S)

    R, rows = B * N, B * D
    chan = product(2 * R * D * C, 2 * (R * D + D * C + R * C)) + \
        product(2 * R * D * C, 2 * (R * C + C * D) + 4 * R * D)
    if token_products:
        tok = product(2 * rows * N * T, 2 * (rows * N + N * T + rows * T)) + \
            product(2 * rows * N * T, 2 * (rows * T + T * N) + 4 * rows * N)
    else:
        tok = 4 * rows * N * T / PEAK["f32"]
    return (chan + tok) * 1e3


def bf16_bwd_design_ms(B, N, D, T, C, token_products: bool) -> float:
    """The bf16 K1b design's pass-count bound (ms) of one block: the channel
    FF's nine bf16 passes on the wgmma engine (a3, dh2 and dW4 once, dz and dW3
    three times, 2*B*N*D*C flops each) at the dense bf16 peak, and the token
    FF's six products (2*B*D*N*T each) at the rate they run: on the token
    pipeline four in 2xTF32 and the recomputed two in 1xTF32, on the register
    route on the float32 CUDA cores."""
    chan = 9 * 2 * B * N * D * C / PEAK["bf16"]
    tok = 2 * B * D * N * T
    tok_s = 4 * tok / TC_2XTF32 + 2 * tok / (2 * TC_2XTF32) if token_products \
        else 6 * tok / PEAK["f32"]
    return (chan + tok_s) * 1e3


def bf16_gmlp_design_ms(B, N, D, F) -> tuple:
    """(forward, backward) bound (ms) of the bf16 K3f / K3b design on one gMLP
    block: each wgmma-engine product at the larger of its flops at the dense
    bf16 peak and its bf16 operands and output (float32 where the design
    stores float32) at HBM rate, dpre's three planes counted as three passes
    of dxn and dW_in; every other kernel at its bytes (each input read once,
    each output written once) at HBM rate. Forward: LN rows (x in, xn out),
    the in-projection (h out), LN(v)'s statistics, the SGU (h in, gated out)
    and the out-projection (x in, y out).
    Backward: LN rows (x, g in; xn, dout out), the in-projection (pm out),
    dgated, the statistics, the SGU backward (pm, dgated in; gated, dpre's u
    planes, dv' out), LN(v)'s backward (pm's v half, dv' in; dpre's v
    planes out), dxn, dW_in, dW_out and LN1's backward (x, g, dxn in; dx
    out); the weights' copies and the partials' reductions are left out."""
    def product(flops, nbytes):
        return max(flops / PEAK["bf16"], nbytes / HBM_BYTES_PER_S)

    R, H = B * N, F // 2
    hbm = lambda nbytes: nbytes / HBM_BYTES_PER_S  # noqa: E731
    fwd = (hbm(4 * R * D + 2 * R * D) + product(2 * R * D * F, 2 * (R * D + D * F) + 4 * R * F)
           + hbm(4 * R * H) + hbm(4 * R * F + 2 * R * H)
           + product(2 * R * H * D, 2 * (R * H + H * D) + 8 * R * D))
    bwd = (hbm(8 * R * D + 4 * R * D) + product(2 * R * D * F, 2 * (R * D + D * F) + 4 * R * F)
           + product(2 * R * D * H, 2 * (R * D + D * H + R * H)) + hbm(4 * R * H)
           + hbm(4 * R * F + 2 * R * H + 2 * R * H + 6 * R * H + 2 * R * H)
           + hbm(4 * R * H + 2 * R * H + 6 * R * H)
           + product(3 * 2 * R * F * D, 6 * R * F + 2 * D * F + 4 * R * D)
           + product(3 * 2 * R * D * F, 2 * R * D + 6 * R * F + 4 * D * F)
           + product(2 * R * H * D, 2 * (R * H + R * D) + 4 * H * D) + hbm(16 * R * D))
    return fwd * 1e3, bwd * 1e3



def bf16_dyna_design_ms(S, L, C, H, R) -> tuple:
    """(forward, backward) bound (ms) of the bf16 K4f / K4b design on one
    DynaMixerOp of S sequences, counted as bf16_gmlp_design_ms counts: each
    wgmma-engine product at the larger of its flops at the dense bf16 peak
    and its operands (bf16; a float32 one as three planes, three passes) and
    output at HBM rate; every other kernel at its bytes. Forward: x and the
    weights rounded (x in, xb out), compress (gin out, bf16), generate (logits
    out, float32), the mix (logits, xb in; mixed out) and the output product
    (y out, float32). Backward: x, g (into three planes) and the weights
    rounded, compress and generate again, d_mixed, the sequence step (logits,
    xb, d_mixed in; mixed, dx, d_logit and its planes out), d_gin (d_comp out),
    dx's compress part (dx read and written), dW_c, dW_g and dW_o; the
    column sums and the reduction are left out."""
    def product(flops, nbytes):
        return max(flops / PEAK["bf16"], nbytes / HBM_BYTES_PER_S)

    rows, units, HR, LR, LL = S * L, S * H, H * R, L * R, L * L
    hbm = lambda nbytes: nbytes / HBM_BYTES_PER_S  # noqa: E731
    logits = product(2 * rows * C * HR, 2 * (rows * C + HR * C + units * LR)) + \
        product(2 * units * LR * LL, 2 * (units * LR + LL * LR) + 4 * units * LL)
    fwd = (hbm(4 * rows * C + 2 * rows * C) + logits + hbm(4 * units * LL + 4 * rows * C)
           + product(2 * rows * C * C, 2 * (rows * C + C * C) + 4 * rows * C))
    bwd = (hbm(8 * rows * C + 8 * rows * C) + logits
           + product(6 * rows * C * C, 6 * rows * C + 2 * C * C + 2 * rows * C)
           + hbm(4 * units * LL + 6 * rows * C + 4 * rows * C + 10 * units * LL)
           + product(6 * units * LL * LR, 6 * units * LL + 2 * LL * LR + 6 * rows * HR)
           + product(2 * rows * HR * C, 2 * rows * HR + 2 * HR * C + 8 * rows * C)
           + product(2 * rows * C * HR, 2 * rows * C + 2 * rows * HR + 4 * C * HR)
           + product(6 * units * LL * LR, 6 * units * LL + 2 * units * LR + 4 * LL * LR)
           + product(6 * rows * C * C, 8 * rows * C + 4 * C * C))
    return fwd * 1e3, bwd * 1e3


def device_busy_ms(torch, fn, calls: int = 3) -> float:
    """Device time per call of ``fn`` (ms): its kernels' device time summed
    (``torch.profiler``); against the call's CUDA-event time it gives the
    share of the call in which the card is busy."""
    return sum(us for us, _ in kernel_breakdown(torch, fn, None, calls).values()) / 1e3


def grad_err(torch, got, want, what: str, dead=()) -> float:
    """Gradient check: every tensor within GRAD_REL x max(1, max|plain|);
    returns the worst absolute error. A gradient that is exactly zero in the
    math (the token FF's output bias b2 under a following LayerNorm: a sum
    of B*D terms that cancel) is float noise on both sides, of ~1e-4 at
    batch 512; it passes when both sides stay below ZERO_GRAD everywhere.
    ``dead`` marks such gradients where the noise scales past ZERO_GRAD (the
    L stacks: 262,144 terms of a residual stream in the tens): both sides
    within GRAD_REL x the largest gradient of the call, as bf16_grad_check
    holds its dead leaves."""
    dead = tuple(dead) or (False,) * len(want)
    call = max(w.abs().max().item() for w in want)
    worst, zeros = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: tensor {i} is not finite")
        scale = b.abs().max().item()
        if dead[i]:
            noise = max(scale, a.abs().max().item())
            if not noise <= GRAD_REL * call:
                raise AssertionError(f"{what}: exactly-zero tensor {i} reaches {noise} > "
                                     f"{GRAD_REL} x {call}")
            zeros += 1
            continue
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


def plain_grouped(mk, x, blocks, s, b, seed, rate, group_size, approx, compute_dtype=None):
    """The plain version of fused_mixer_stack_grouped (group seeds folded)."""
    k = len(blocks)
    cd = compute_dtype or x.dtype
    if group_size <= 0 or group_size >= k:
        return mk.mixer_stack_reference(x, mk.stack_flat_params(blocks, s, b), cd,
                                        approximate_gelu=approx, dropout_rate=rate, seed=seed)
    for gi, start in enumerate(range(0, k, group_size)):
        group = blocks[start:start + group_size]
        last = start + len(group) >= k
        flat = mk.stack_flat_params(group, s, b) if last else mk.stack_flat_params(group)
        x = mk.mixer_stack_reference(x, flat, cd, final_ln=last, approximate_gelu=approx,
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


# [2/16] and [3/16]: batch 512 in float32 and bf16, and in float32 also batch 32
# and 600 (above the 512 bucket: more rows than the batch-512 plans)
FWD_CASES = ((512, ("f32", "bf16")), (32, ("f32",)), (600, ("f32",)))


def phase_kernels(torch, mk, report):
    print("[2/16] K1f fused_mixer_block vs plain version")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        blocks, _, _ = rand_blocks(mk, torch, 1, seed=11, **geom)
        for B, names in FWD_CASES:
            x = torch.randn(B, geom["N"], geom["D"], generator=torch.Generator().manual_seed(1)).cuda()
            for dtype in names:
                cd = dtypes[dtype]
                for approx in (False, True):
                    got = mk.fused_mixer_block(x, blocks[0], compute_dtype=cd,
                                               approximate_gelu=approx)
                    want = mk.mixer_block_reference(x, blocks[0], compute_dtype=cd,
                                                    approximate_gelu=approx)
                    batch = "" if B == 512 else f"B{B}/"
                    key = f"K1f/{geom_name}/{batch}{dtype}/{'tanh' if approx else 'erf'}"
                    if dtype == "f32":
                        report["errors"][key] = max_err(torch, got, want, key)
                    else:
                        control = mk.mixer_block_reference(x, blocks[0], approximate_gelu=approx)
                        report["errors"][key] = bf16_err(torch, got, want,
                                                         round_bf16(torch, control), key, report)
                        check_fwd_engine_route(launch_counts(torch, lambda: mk.fused_mixer_block(
                            x, blocks[0], compute_dtype=cd, approximate_gelu=approx)), key)

    print("[3/16] K2f fused_mixer_stack vs plain version")
    cases = [("encoder", ENC, 4, 0), ("encoder", ENC, 4, 2), ("fusion", FUSION, 2, 0)]
    for geom_name, geom, K, group in cases:
        blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=12, **geom)
        flat = mk.stack_flat_params(blocks, ln_s, ln_b)
        for B, names in FWD_CASES:
            x = torch.randn(B, geom["N"], geom["D"], generator=torch.Generator().manual_seed(2)).cuda()
            for dtype in names:
                cd = dtypes[dtype]
                for approx in (False, True):
                    got = mk.fused_mixer_stack_grouped(x, blocks, ln_s, ln_b, compute_dtype=cd,
                                                       group_size=group, approximate_gelu=approx)
                    want = mk.mixer_stack_reference(x, flat, compute_dtype=cd,
                                                    approximate_gelu=approx)
                    batch = "" if B == 512 else f"B{B}/"
                    key = (f"K2f/{geom_name}x{K}/g{group}/{batch}{dtype}/"
                           f"{'tanh' if approx else 'erf'}")
                    if dtype == "f32":
                        report["errors"][key] = max_err(torch, got, want, key)
                    else:
                        control = mk.mixer_stack_reference(x, flat, approximate_gelu=approx)
                        report["errors"][key] = bf16_err(torch, got, want,
                                                         round_bf16(torch, control), key, report)
                        check_fwd_engine_route(launch_counts(
                            torch, lambda: mk.fused_mixer_stack_grouped(
                                x, blocks, ln_s, ln_b, compute_dtype=cd, group_size=group,
                                approximate_gelu=approx)), key, K)


def phase_backward(torch, mk, report):
    print("[4/16] K1b / K2b backward kernels vs autograd of the plain versions")
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


def train_step_one(torch, task, batch):
    """([loss, branch losses...], {name: gradient}) of one training forward
    and backward of ``task`` on ``batch`` (no optimizer step)."""
    task.network.train()
    task.network.zero_grad(set_to_none=True)
    loss, aux = task.step(batch, task.make_ctx(0, "train"), train=True)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in task.network.named_parameters()}
    return [loss.detach()] + [aux["losses"][k].detach() for k in task.loss_names], grads


def train_run(run, np, argv, zero, read, what: str, min_acc: float) -> dict:
    """``run.main(argv)``, a main-path run: the launch counters zeroed
    (``zero()``) just before and read (``read()``) just after. Returns the
    run's numbers; raises unless its metrics are finite, the last epoch's
    train loss is below the first's, and val and test accuracy reach
    ``min_acc``."""
    zero()
    t0 = time.time()
    trainer = run.main(argv)
    launches = read()
    seconds = time.time() - t0
    with open(os.path.join(trainer.logger.log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    val = [ln for ln in lines if "val_loss" in ln]
    test = [ln for ln in lines if "test_loss" in ln][-1]
    result = {"launches": launches, "seconds": seconds,
              "train_loss": [ln["train_loss"] for ln in lines if "train_loss" in ln],
              "val_loss": [ln["val_loss"] for ln in val],
              "val_acc": [ln["val_acc"] for ln in val], "test_acc": test["test_acc"],
              "test_loss": test["test_loss"]}
    print(f"  {what}: {json.dumps(result)}")
    if not all(np.isfinite(v) for ln in lines for v in ln.values()):
        raise AssertionError(f"{what}: non-finite metrics")
    if not result["train_loss"][-1] < result["train_loss"][0]:
        raise AssertionError(f"{what}: train loss did not fall: {result['train_loss']}")
    if not (result["val_acc"][-1] >= min_acc and result["test_acc"] >= min_acc):
        raise AssertionError(f"{what}: accuracy below {min_acc}: {result}")
    return result


def zero_counters(mk):
    for fn in (mk.fused_mixer_block, mk.fused_mixer_stack, mk.fused_mixer_block_bwd,
               mk.fused_mixer_stack_bwd):
        fn.launches = 0


def counters(mk):
    return {"K1f": mk.fused_mixer_block.launches, "K2f": mk.fused_mixer_stack.launches,
            "K1b": mk.fused_mixer_block_bwd.launches, "K2b": mk.fused_mixer_stack_bwd.launches}


def phase_training(torch, mk, serving, run, apply_overrides, load_cfg, synthetic, np, report):
    print("[10/16] training the B config through the kernel block types")
    plain, cfg = kernel_task(serving, apply_overrides, load_cfg, "plain", ["model.dropout=0.0"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic(32, seed=3, learnable=True).items()}
    step_one = lambda task: train_step_one(torch, task, batch)
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
            runs[flavor] = train_run(run, np, train_args(tmp, f"smoke_{flavor}", flavor),
                                     lambda: zero_counters(mk), lambda: counters(mk), flavor,
                                     MIN_ACC)
            for name in ("K2f", "K2b") if flavor == "stacked" else ("K1f", "K1b"):
                if runs[flavor]["launches"][name] <= 0:
                    raise AssertionError(f"{name} was never launched on the training path")
    report["training_launches"] = {"K1b": runs["per_block"]["launches"]["K1b"],
                                   "K2b": runs["stacked"]["launches"]["K2b"]}


def phase_serving(torch, mk, serving, get_model, load_cfg, np, report):
    print("[7/16] serving the B config through the kernel blocks")
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
    print("[13/16] times (CUDA events, median of 5 runs of 20 calls)")
    times, tc = report["times_ms"], report.setdefault("bounds_3xtf32_ms", {})
    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        for B in (32, 512):
            K = 4 if geom_name == "encoder" else 2
            blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=13, **geom)
            flat = mk.stack_flat_params(blocks, ln_s, ln_b)
            x = torch.randn(B, geom["N"], geom["D"], generator=torch.Generator().manual_seed(3)).cuda()
            for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                tag = f"{geom_name}/B{B}/{dtype}"
                # float32 weights, as the kernel-backed modules hold them (in bf16
                # the wrapper hands the kernel bf16 copies of w3/w4 on each call)
                block = mk.MixerBlockParams(*flat[:12])
                times[f"K1f/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_block(
                    x, block, compute_dtype=cd))
                times[f"K1f_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_block_reference(
                    x, block, compute_dtype=cd))
                times[f"K2f/{tag}"] = cuda_ms(torch, lambda: mk.fused_mixer_stack(
                    x, flat, compute_dtype=cd))
                times[f"K2f_plain/{tag}"] = cuda_ms(torch, lambda: mk.mixer_stack_reference(
                    x, flat, compute_dtype=cd))
                flops, pbytes = block_work(B, **geom, wbytes=2 if dtype == "bf16" else 4)
                act = 2 * B * geom["N"] * geom["D"] * 4
                report["bounds_ms"][f"K1f/{tag}"] = bound(flops, pbytes + act, dtype)
                report["bounds_ms"][f"K2f/{tag}"] = bound(
                    K * flops, K * pbytes + 8 * geom["D"] + act, dtype)
                if dtype == "f32":  # the float32 route's products run in 3xTF32
                    tc[f"K1f/{tag}"] = flops / TC_3XTF32 * 1e3
                    tc[f"K2f/{tag}"] = K * flops / TC_3XTF32 * 1e3
                    tc_note = f", 3xTF32 bounds {tc[f'K1f/{tag}']:.4f} / {tc[f'K2f/{tag}']:.4f}"
                else:  # bf16: the wgmma engine's design (token FF in registers)
                    design = report.setdefault("bounds_design_ms", {})
                    design[f"K1f/{tag}"] = bf16_fwd_design_ms(B, geom["N"], geom["D"], geom["T"],
                                                              geom["C"], False)
                    design[f"K2f/{tag}"] = K * design[f"K1f/{tag}"]
                    tc_note = (f", design bounds {design[f'K1f/{tag}']:.4f} / "
                               f"{design[f'K2f/{tag}']:.4f}")
                print(f"  {tag}: K1f {times[f'K1f/{tag}']:.4f} ms (plain "
                      f"{times[f'K1f_plain/{tag}']:.4f}, bound "
                      f"{report['bounds_ms'][f'K1f/{tag}'][0]:.4f}); K2f x{K} "
                      f"{times[f'K2f/{tag}']:.4f} ms (plain {times[f'K2f_plain/{tag}']:.4f}, "
                      f"bound {report['bounds_ms'][f'K2f/{tag}'][0]:.4f}){tc_note}")
                if dtype == "f32" and B == 512:
                    report.setdefault("breakdown_us", {})[f"K1f/{geom_name}/B512"] = \
                        kernel_breakdown(torch, lambda: mk.fused_mixer_block(x, block),
                                         f"K1f {geom_name}/B512")

    fwd = {"plain": serving.serve_fn(plain)}
    fwd.update({k: m.forward_device for k, m in models.items()})
    times.update(b_served_times(torch, np, fwd))
    for B in (32, 512):
        print(f"  served forward B={B}: " + ", ".join(
            f"{k} {times[f'served/{k}/B{B}']:.4f} ms" for k in fwd))
    feats = b_features(torch, np, 32)
    mk.fused_mixer_block.launches = mk.fused_mixer_stack.launches = 0
    models["stacked"].forward_device(feats)
    per_fwd = mk.fused_mixer_stack.launches
    mk.fused_mixer_block.launches = mk.fused_mixer_stack.launches = 0
    models["per_block"].forward_device(feats)
    report["launches_per_forward"] = {"K2f (stacked)": per_fwd,
                                      "K1f (per_block)": mk.fused_mixer_block.launches}
    print(f"  launches per served forward: {report['launches_per_forward']}")


MIXER_STACKS = (("encoder", ENC, 4), ("fusion", FUSION, 2))  # the B config's two stack kinds


def mixer_bwd_calls(torch, mk, geom, K, B):
    """K1b and K2b (K blocks + LN) at the training config's dropout 0.5, and
    their plain versions, on seeded inputs, in float32 and in bf16 compute:
    {name: call}."""
    blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=23, **geom)
    flat = mk.stack_flat_params(blocks, ln_s, ln_b)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
    g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
    calls = {}
    for suffix, cd in (("", torch.float32), ("_bf16", torch.bfloat16)):
        with torch.no_grad():
            _, saved = mk._stack_forward(x, flat, 1, 0.5, cd, True, False, save=True)
        calls.update({
            f"K1b{suffix}": lambda cd=cd: mk.fused_mixer_block_bwd(
                x, g, blocks[0], seed=1, dropout_rate=0.5, compute_dtype=cd),
            f"K1b{suffix}_plain": lambda cd=cd: mk.mixer_block_bwd_reference(
                x, g, blocks[0], 0.5, cd, seed=1),
            f"K2b{suffix}": lambda cd=cd, saved=saved: mk.fused_mixer_stack_bwd(
                x, g, flat, seed=1, dropout_rate=0.5, compute_dtype=cd, saved=saved),
            f"K2b{suffix}_plain": lambda cd=cd: mk.mixer_stack_bwd_reference(
                x, g, flat, 0.5, cd, seed=1)})
    return calls


def phase_train_times(torch, mk, serving, Trainer, apply_overrides, load_cfg, synthetic, report):
    """Backward kernels alone (training config: dropout 0.5) and the train step."""
    times, tc = report["times_ms"], report.setdefault("bounds_3xtf32_ms", {})
    for geom_name, geom, K in MIXER_STACKS:
        for B in (32, 512):
            tag = f"{geom_name}/B{B}"
            calls = mixer_bwd_calls(torch, mk, geom, K, B)
            for name, fn in calls.items():
                if "bf16" not in name:  # phase_bf16_times times those
                    times[f"{name}/{tag}"] = cuda_ms(torch, fn)
            if B == 512:
                report.setdefault("breakdown_us", {})[f"K1b/{tag}"] = kernel_breakdown(
                    torch, calls["K1b"], f"K1b {tag}")
            flops, nbytes = bwd_work(B, **geom)
            act = 3 * B * geom["N"] * geom["D"] * 4  # x, g and dx
            ln_bytes = 4 * 4 * geom["D"]  # final LN scale and bias, read and their grads written
            report["bounds_ms"][f"K1b/{tag}"] = bound(flops, nbytes, "f32")
            report["bounds_ms"][f"K2b/{tag}"] = bound(K * flops, K * (nbytes - act) + act
                                                      + ln_bytes, "f32")
            tc[f"K1b/{tag}"] = flops / TC_3XTF32 * 1e3
            tc[f"K2b/{tag}"] = K * flops / TC_3XTF32 * 1e3
            print(f"  {tag}: K1b {times[f'K1b/{tag}']:.4f} ms (plain "
                  f"{times[f'K1b_plain/{tag}']:.4f}, bound "
                  f"{report['bounds_ms'][f'K1b/{tag}'][0]:.4f}, 3xTF32 bound "
                  f"{tc[f'K1b/{tag}']:.4f}); K2b x{K} {times[f'K2b/{tag}']:.4f} ms (plain "
                  f"{times[f'K2b_plain/{tag}']:.4f}, bound "
                  f"{report['bounds_ms'][f'K2b/{tag}'][0]:.4f}, 3xTF32 bound "
                  f"{tc[f'K2b/{tag}']:.4f})")
    times.update(b_train_step_times(torch, serving, Trainer, apply_overrides, load_cfg, synthetic))
    print("  train step (forward + backward + Adam, dropout 0.5): " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items() if k.startswith("train_step/")))


def b_train_step_times(torch, serving, Trainer, apply_overrides, load_cfg, synthetic) -> dict:
    """The B config's train step (forward, the three losses, backward, Adam;
    the config's dropout 0.5) at batch 32 and 512 for plain modules and both
    kernel block types, seeded weights (CUDA events, median of 5 runs of 10)."""
    times = {}
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
    return times


def b_features(torch, np, B: int) -> dict:
    """A seeded batch of B config inputs on the card."""
    rng = np.random.RandomState(B)
    return {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
            "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}


def b_served_times(torch, np, fwd: dict) -> dict:
    """The B config's eval-mode forward at batch 32 and 512 through each of
    ``fwd``'s functions ({flavor: forward}: plain modules and the two kernel
    block types), CUDA events, median of 5 runs of 20."""
    times = {}
    for B in (32, 512):
        feats = b_features(torch, np, B)
        for flavor, fn in fwd.items():
            times[f"served/{flavor}/B{B}"] = cuda_ms(torch, lambda: fn(feats))
    return times


# ------------------------------------------------- bf16 training: B_turbo
TURBO_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_m2-mixer_B_turbo.yml")
# which of a block's 12 gradients bf16 compute rounds to bf16 (the transposes
# of its casts): all but the biases b1..b4, which add in float32
BF16_ROUNDED = (True, True, True, False, True, False, True, True, True, False, True, False)
# the share of the rounded gradients' elements allowed to differ from the plain
# version's, all of a call's tensors taken together: a reduction over upstream
# values that each may sit one bf16 ulp off rounds to the other neighbour now
# and then, and through a stack of blocks that compounds; the tile's float32
# accumulation, less exact than cuBLAS's, adds flips of its own. The plain
# version on the CPU against the card's measures that floor each run
# (``cpu_share_differing``). K1b's limit is the bf16 forward's; K2b's sits above
# the floor of a 4-block stack; the float32-math control exceeds both
BF16_GRAD_SHARE = {"K1b": 0.10, "K2b": 0.40}
# served logits of the bf16 K2f stacks against the paired plain network: the
# two round at different points (the paired chain keeps its LN statistics in
# bf16, the kernels in float32), as the plain bf16 modules and flax do
TURBO_SERVED_REL = 5e-2
TURBO_FLAVORS = ("paired", "stacked", "per_block")  # paired: the config as shipped (path a)
TC_2XTF32 = 495e12 / 2  # one bf16 operand: two of 3xTF32's three TF32 products
# the token FF's output bias in the plain, paired, stacked and per-block layouts
TOKEN_OUT_BIAS = ("token_mix.fc2.bias", "token_fc2_bias", "_b2", ".b2")


def bf16_grad_check(torch, got, want, control, cpu, rounded, limit, what, report,
                    dead=(), second_name="the plain version on the CPU", excess=None) -> float:
    """bf16 gradients: every tensor finite and within BF16_REL x max(1,
    max|plain|); those a cast rounds on the bf16 grid, and of all their
    elements at most ``limit`` differing from the plain version's. A gradient
    that is exactly zero in the math (``dead``: the token FF's output bias of
    a block followed only by LayerNorms, at dropout 0) is rounding noise on
    both sides in bf16, a sum of B*D residual-stream values each rounded to
    bf16 (about 0.5 at batch 32): both sides within BF16_REL x the largest
    gradient of the call, as the JAX package's bf16 gradient test holds its
    dead leaves. The ``control`` (the float32 backward, rounded where the
    bf16 one rounds) must fail the same check. ``cpu``: the plain version on
    the CPU, a second correct implementation; the share of its rounded
    elements that differ from the card's plain version is reported, the
    floor any implementation of these sums meets (None: not run, at shapes
    where the CPU would take too long; ``second_name`` names another second
    implementation passed in its place; with ``excess``, the share limit is
    that implementation's share + ``excess``). Returns the worst absolute
    error."""
    dead = tuple(dead) or (False,) * len(want)
    scale = max(w.abs().max().item() for w in want)

    def stats(ts):
        ratio = worst = diff = total = 0
        grid = True
        for a, w, r, d in zip(ts, want, rounded, dead):
            if d:
                ratio = max(ratio, max(a.abs().max().item(), w.abs().max().item())
                            / (BF16_REL * scale))
                continue
            err = (a - w).abs().max().item()
            worst = max(worst, err)
            ratio = max(ratio, err / (BF16_REL * max(1.0, w.abs().max().item())))
            if r:
                grid = grid and bool((a == a.to(torch.bfloat16).float()).all())
                diff += int((a != w).sum())
                total += a.numel()
        return ratio, worst, diff / total, grid

    if not all(bool(torch.isfinite(a).all()) for a in got):
        raise AssertionError(f"{what}: non-finite gradient")
    ratio, worst, share, grid = stats(got)
    c_ratio, c_worst, c_share, c_grid = stats(control)
    cpu_share = None if cpu is None else stats([t.to(want[0].device) for t in cpu])[2]
    if excess is not None:  # the limit: the second implementation's share + excess
        limit = cpu_share + excess
    cpu_note = "not run" if cpu_share is None else f"{cpu_share:.4f}"
    print(f"  {what}: worst |err| {worst:.3e} ({ratio:.3f} of its tolerance), rounded elements "
          f"differing {share:.4f} (tol {limit}; {second_name} {cpu_note}); "
          f"float32-math control: {c_ratio:.3f} of tolerance, differing {c_share:.4f}")
    report["bf16_checks"][what] = {"max_abs_err": worst, "err_over_tol": ratio,
                                   "share_differing": share, "share_limit": limit,
                                   "cpu_share_differing": cpu_share,
                                   "control_err_over_tol": c_ratio,
                                   "control_share_differing": c_share}
    if not (grid and ratio <= 1.0 and share <= limit):
        raise AssertionError(f"{what}: on bf16 grid {grid}, error {ratio} of tolerance, "
                             f"share differing {share} (tol {limit})")
    if c_grid and c_ratio <= 1.0 and c_share <= limit:
        raise AssertionError(f"{what}: the float32-math control passes the bf16 check, "
                             "so the check cannot see skipped rounding points")
    return worst


def phase_bf16_backward(torch, mk, report):
    print("[4/16] K1b / K2b in bf16 compute vs autograd of the plain bf16 versions "
          "(float32 parameters, w3/w4 read rounded to bf16)")
    bf16 = torch.bfloat16
    for B in (32, 512):
        for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
            blocks, _, _ = rand_blocks(mk, torch, 1, seed=21, **geom)
            gen = torch.Generator().manual_seed(B)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for rate in (0.0, 0.5):
                for approx in (False, True):
                    key = f"K1b_bf16/{geom_name}/B{B}/rate{rate}/{'tanh' if approx else 'erf'}"
                    run = lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], seed=7,
                                                           dropout_rate=rate, compute_dtype=bf16,
                                                           approximate_gelu=approx)
                    dx, grads = run()
                    want = mk.mixer_block_bwd_reference(x, g, blocks[0], rate, bf16, approx,
                                                        seed=7)
                    f32 = mk.mixer_block_bwd_reference(x, g, blocks[0], rate,
                                                       approximate_gelu=approx, seed=7)
                    cpu = mk.mixer_block_bwd_reference(
                        x.cpu(), g.cpu(), [t.cpu() for t in blocks[0]], rate, bf16, approx,
                        seed=7)
                    rounded = (True, *BF16_ROUNDED)
                    control = [round_bf16(torch, t) if r else t
                               for t, r in zip((f32[0], *f32[1]), rounded)]
                    report["errors"][key] = bf16_grad_check(
                        torch, (dx, *grads), (want[0], *want[1]), control, (cpu[0], *cpu[1]),
                        rounded, BF16_GRAD_SHARE["K1b"], key, report)
                    dx2, grads2 = run()
                    if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                        raise AssertionError(f"{key}: two backward runs differ")
    for B in (32, 512):
        blocks, s, b = rand_blocks(mk, torch, 4, seed=22, **ENC)
        gen = torch.Generator().manual_seed(B + 1)
        x = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        g = torch.randn(B, ENC["N"], ENC["D"], generator=gen).cuda()
        for group in (0, 2):
            for rate in (0.0, 0.5):
                for approx in (False, True):
                    key = (f"K2b_bf16/encoderx4/g{group}/B{B}/rate{rate}/"
                           f"{'tanh' if approx else 'erf'}")
                    leaves = [t.detach().requires_grad_() for blk in blocks for t in blk]
                    ls, lb = s.detach().requires_grad_(), b.detach().requires_grad_()
                    lblocks = [mk.MixerBlockParams(*leaves[i:i + 12]) for i in range(0, 48, 12)]
                    xx = x.detach().requires_grad_()
                    wrt = [xx, *leaves, ls, lb]

                    def run():
                        out = mk.fused_mixer_stack_grouped(xx, lblocks, ls, lb, seed=9,
                                                           dropout_rate=rate, compute_dtype=bf16,
                                                           group_size=group,
                                                           approximate_gelu=approx)
                        return torch.autograd.grad(out, wrt, g)

                    got = run()
                    want = torch.autograd.grad(plain_grouped(mk, xx, lblocks, ls, lb, 9, rate,
                                                             group, approx, bf16), wrt, g)
                    f32 = torch.autograd.grad(plain_grouped(mk, xx, lblocks, ls, lb, 9, rate,
                                                            group, approx), wrt, g)
                    cwrt = [t.detach().cpu().requires_grad_() for t in wrt]
                    cblocks = [mk.MixerBlockParams(*cwrt[1 + i:13 + i]) for i in range(0, 48, 12)]
                    cpu = torch.autograd.grad(plain_grouped(mk, cwrt[0], cblocks, cwrt[-2],
                                                            cwrt[-1], 9, rate, group, approx,
                                                            bf16), cwrt, g.cpu())
                    rounded = (True, *(BF16_ROUNDED * 4), True, True)
                    control = [round_bf16(torch, t) if r else t for t, r in zip(f32, rounded)]
                    # every block's b2 is exactly zero in the math at dropout 0
                    b2 = tuple(i == 5 and rate == 0.0 for i in range(12))
                    report["errors"][key] = bf16_grad_check(
                        torch, got, want, control, cpu, rounded, BF16_GRAD_SHARE["K2b"], key,
                        report, dead=(False, *(b2 * 4), False, False))
                    if not all(torch.equal(a, c) for a, c in zip(got, run())):
                        raise AssertionError(f"{key}: two backward runs differ")


def turbo_task(serving, apply_overrides, load_cfg, flavor, extra=(), device="cuda"):
    cfg = load_cfg(TURBO_CFG)
    apply_overrides(cfg, [*KERNEL_BLOCKS.get(flavor, []), *extra], warn=False)
    return serving._build_task(cfg, device=device), cfg


def turbo_train_args(tmp, name, flavor):
    return ["-c", TURBO_CFG, "-n", name, f"train.tensorboard_path={tmp}", "train.epochs=2",
            "dataset.params.synthetic=true", "dataset.params.synthetic_learnable=true",
            f"dataset.params.synthetic_sizes={TRAIN_SIZES}", *KERNEL_BLOCKS.get(flavor, [])]


def bf16_counters(mk):
    return {"K1b_bf16": mk.fused_mixer_block_bwd.bf16_launches,
            "K2b_bf16": mk.fused_mixer_stack_bwd.bf16_launches, **counters(mk)}


def zero_bf16_counters(mk):
    zero_counters(mk)
    mk.fused_mixer_block_bwd.bf16_launches = mk.fused_mixer_stack_bwd.bf16_launches = 0


def phase_turbo_training(torch, mk, serving, run, apply_overrides, load_cfg, synthetic, np,
                         report, tmp):
    """Paths (a) (the config as shipped: paired encoders, plain fusion mixer)
    and (b) (both kernel block types: bf16 K1f/K1b, K2f/K2b) of B_turbo.
    Returns the best weights of the path-(a) run."""
    print("[10/16] training B_turbo (bf16, paired encoders, bf16 Adam moment): step 1 on the "
          "card against the CPU, then 2-epoch runs")
    batch = synthetic(32, seed=3, learnable=True)
    for flavor in TURBO_FLAVORS:
        task, cfg = turbo_task(serving, apply_overrides, load_cfg, flavor, ["model.dropout=0.0"])
        cpu, _ = turbo_task(serving, apply_overrides, load_cfg, flavor, ["model.dropout=0.0"],
                            device="cpu")
        cpu.network.load_state_dict(task.network.state_dict())
        zero_bf16_counters(mk)
        g_losses, g_grads = train_step_one(torch, task, {k: torch.from_numpy(v).cuda()
                                                         for k, v in batch.items()})
        launched = bf16_counters(mk)
        c_losses, c_grads = train_step_one(torch, cpu, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
        if flavor != "paired" and launched["K1b_bf16"] + launched["K2b_bf16"] <= 0:
            raise AssertionError(f"B_turbo step 1 ({flavor}) launched no bf16 backward kernel")
        names = sorted(g_grads)
        key = f"B_turbo step 1/{flavor}: loss, branch losses"
        report["errors"][key] = rel_err(torch, torch.stack(g_losses).cpu(),
                                        torch.stack(c_losses), key, BF16_REL)
        key = f"B_turbo step 1/{flavor}: {len(names)} parameter gradients"
        # the token FF's output biases: every block is followed only by
        # LayerNorms, so their gradients are exactly zero in the math and
        # bf16 rounding noise on both sides (bf16_grad_check)
        dead = [n for n in names if n.endswith(TOKEN_OUT_BIAS)]
        live = [n for n in names if n not in dead]
        report["errors"][key] = rel_err(torch, [g_grads[n].cpu() for n in live],
                                        [c_grads[n] for n in live], key, BF16_REL)
        scale = max(c_grads[n].abs().max().item() for n in names)
        noise = max(max(g_grads[n].abs().max().item(), c_grads[n].abs().max().item())
                    for n in dead)
        print(f"  {len(dead)} exactly-zero gradients (token FF output biases): at most "
              f"{noise:.3e} on either side (tol {BF16_REL} x {scale:.3e})")
        if not dead or not noise <= BF16_REL * scale:
            raise AssertionError(f"{key}: exactly-zero gradients {dead} reach {noise}")
        del task, cpu

    runs = report["turbo_runs"] = {}
    for flavor in TURBO_FLAVORS:
        runs[flavor] = train_run(run, np, turbo_train_args(tmp, f"turbo_{flavor}", flavor),
                                 lambda: zero_bf16_counters(mk), lambda: bf16_counters(mk),
                                 f"B_turbo {flavor}", MIN_ACC)
        got = runs[flavor]["launches"]
        if flavor == "paired" and any(got.values()):
            raise AssertionError(f"the plain B_turbo run launched mixer kernels: {got}")
        for name in {"stacked": ("K2f", "K2b_bf16"), "per_block": ("K1f", "K1b_bf16")}.get(
                flavor, ()):
            if got[name] <= 0:
                raise AssertionError(f"{name} was never launched on the B_turbo training path")
    report["turbo_training_launches"] = {"K1b_bf16": runs["per_block"]["launches"]["K1b_bf16"],
                                         "K2b_bf16": runs["stacked"]["launches"]["K2b_bf16"]}
    log_root = os.path.join(tmp, "turbo_paired")
    version = sorted(os.listdir(log_root))[-1]
    return os.path.join(log_root, version, "checkpoints", "best.npz")


def phase_turbo_serving(torch, mk, serving, load_cfg, np, report, weights, tmp):
    """Path (c): ``serving export --pallas`` of the trained paired weights
    (per-modality bf16 K2f stacks) against the paired plain network."""
    print("[10/16] serving the trained B_turbo weights through serving export --pallas (bf16 "
          "K2f stacks, the paired encoders un-paired)")
    art = os.path.join(tmp, "turbo_art")
    serving.main(["export", "-c", TURBO_CFG, "-p", weights, "-o", art, "--pallas"])
    model = serving.load_serving(art)
    kinds = {type(m).__name__ for m in model.task.network.modules()}
    if "PallasStackedMLPMixer" not in kinds or "PairedMLPMixer" in kinds:
        raise AssertionError(f"the B_turbo kernel artifact holds {sorted(kinds)}")
    cfg = load_cfg(TURBO_CFG)
    plain = serving._build_task(cfg, device="cuda")
    plain.network.load_state_dict(serving.load_npz(weights, plain.network))
    rng = np.random.RandomState(1)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    mk.fused_mixer_stack.launches = 0
    answers = {n: model.predict(f) for n, f in requests.items()}
    launches = mk.fused_mixer_stack.launches
    print(f"  main-path launches: K2f {launches}")
    if launches <= 0:
        raise AssertionError("K2f was never launched serving B_turbo")
    worst = 0.0
    for n, got in answers.items():
        want = serving.serve_fn(plain)({f: torch.from_numpy(v).cuda()
                                        for f, v in requests[n].items()})
        for g, w in [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                                 want["branch_logits"])):
            w = w.float().cpu().numpy()
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"B_turbo request of {n}: bad output {g.shape}")
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            worst = max(worst, rel)
    print(f"  requests of {list(REQUESTS)}: worst |err| / max|plain| {worst:.3e} "
          f"(tol {TURBO_SERVED_REL})")
    if not worst <= TURBO_SERVED_REL:
        raise AssertionError(f"B_turbo served logits differ from the paired network by {worst}")
    report["turbo_served_rel_err"] = worst
    report["turbo_serving_launches"] = launches
    return model, plain


def phase_bf16_times(torch, mk, serving, Trainer, apply_overrides, load_cfg, synthetic, np,
                     report, served):
    print("[13/16] bf16 K1b / K2b times (CUDA events, median of 5 runs of 20 calls), "
          "B_turbo served forward and train step")
    times, design = report["times_ms"], report.setdefault("bounds_design_ms", {})
    for geom_name, geom, K in MIXER_STACKS:
        for B in (32, 512):
            tag = f"{geom_name}/B{B}"
            calls = {k: v for k, v in mixer_bwd_calls(torch, mk, geom, K, B).items()
                     if "bf16" in k}
            for name, fn in calls.items():
                times[f"{name}/{tag}"] = cuda_ms(torch, fn)
            check_engine_route(launch_counts(torch, calls["K2b_bf16"]), f"K2b bf16 {tag}", K)
            if B == 512:
                report.setdefault("breakdown_us", {})[f"K1b_bf16/{tag}"] = kernel_breakdown(
                    torch, calls["K1b_bf16"], f"K1b bf16 {tag}")
            # the float32 backward's work: the kernel reads the float32 parameters
            # and rounds w3/w4 itself
            flops, nbytes = bwd_work(B, **geom)
            act = 3 * B * geom["N"] * geom["D"] * 4
            ln_bytes = 4 * 4 * geom["D"]
            report["bounds_ms"][f"K1b_bf16/{tag}"] = bound(flops, nbytes, "bf16")
            stack_bytes = K * (nbytes - act) + act + ln_bytes
            report["bounds_ms"][f"K2b_bf16/{tag}"] = bound(K * flops, stack_bytes, "bf16")
            one = bf16_bwd_design_ms(B, geom["N"], geom["D"], geom["T"], geom["C"], False)
            design[f"K1b_bf16/{tag}"] = max(one, nbytes / HBM_BYTES_PER_S * 1e3)
            design[f"K2b_bf16/{tag}"] = max(K * one, stack_bytes / HBM_BYTES_PER_S * 1e3)
            print(f"  {tag}: K1b bf16 {times[f'K1b_bf16/{tag}']:.4f} ms (plain "
                  f"{times[f'K1b_bf16_plain/{tag}']:.4f}, bf16-peak bound "
                  f"{report['bounds_ms'][f'K1b_bf16/{tag}'][0]:.4f}, design bound "
                  f"{design[f'K1b_bf16/{tag}']:.4f}); K2b bf16 x{K} "
                  f"{times[f'K2b_bf16/{tag}']:.4f} ms (plain "
                  f"{times[f'K2b_bf16_plain/{tag}']:.4f}, bf16-peak bound "
                  f"{report['bounds_ms'][f'K2b_bf16/{tag}'][0]:.4f}, design bound "
                  f"{design[f'K2b_bf16/{tag}']:.4f})")
    model, plain = served
    fwd = {"turbo_paired": serving.serve_fn(plain), "turbo_stacked": model.forward_device}
    times.update(b_served_times(torch, np, fwd))
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_turbo_steps_") as tmp:
        for flavor in TURBO_FLAVORS:
            task, cfg = turbo_task(serving, apply_overrides, load_cfg, flavor)
            trainer = Trainer(cfg.train, name=f"turbo_steps_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            for B in (32, 512):
                batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                times[f"turbo_train_step/{flavor}/B{B}"] = cuda_ms(
                    torch, lambda: trainer.train_step(task, batch, ctx), iters=10)
            trainer.logger.close()
            del task, trainer
    print("  B_turbo served forward: " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
        if k.startswith("served/turbo")))
    print("  B_turbo train step (forward + backward + bf16-moment Adam, dropout 0.5): " +
          ", ".join(f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
                    if k.startswith("turbo_train_step/")))


# ---------------------------------------------------------------------- gMLP
def gmlp_params(gk, torch, N, D, F, seed):
    """One gMLP block's parameters (JAX layout) at the modules' init scales
    (Dense U(+-1/sqrt(fan_in)), token projection N(0, 0.02) and bias 1), LN
    parameters jittered away from the identity, on the card."""
    g = torch.Generator().manual_seed(seed)
    H = F // 2
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    jit = lambda n, base: base + 0.1 * torch.randn(n, generator=g)
    p = (jit(D, 1.0), jit(D, 0.0), u(D, D, F), u(D, F), jit(H, 1.0), jit(H, 0.0),
         0.02 * torch.randn(N, N, generator=g), torch.ones(N), u(H, H, D), u(H, D))
    return gk.GmlpBlockParams(*(t.cuda() for t in p))


def rel_err(torch, got, want, what: str, rel: float = GRAD_REL) -> float:
    """The gMLP path's check: every tensor within ``rel`` x max(1, max|plain|)
    (the token projection starts at bias 1, so magnitudes grow with width and
    depth); no tensor is exempt. Returns the worst absolute error."""
    worst, worst_rel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()) or a.shape != b.shape:
            raise AssertionError(f"{what}: tensor {i} is not finite or misshaped")
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        if not err <= rel * scale:
            raise AssertionError(f"{what}: tensor {i}: max |err| {err} > {rel} x {scale}")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
    print(f"  {what}: worst |err| {worst:.3e}, {worst_rel:.2e} of max(1, max|plain|) (tol "
          f"{rel:.0e}) over {len(got)} tensors")
    return worst


def gmlp_work(B, N, D, F):
    """(forward flops, parameter bytes) of one gMLP block in float32."""
    flops = B * N * F * (3 * D + N)  # 2BNDF (D->F) + BFN^2 (token projection) + BNFD (F/2->D)
    params = 2 * D + D * F + F + F + N * N + N + (F // 2) * D + D
    return flops, 4 * params


def phase_gmlp_kernels(torch, gk, report):
    print("[5/16] K3f / K3b fused gMLP block vs the plain version and its autograd")
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        p = gmlp_params(gk, torch, seed=31, **geom)
        for B in (32, 512):
            gen = torch.Generator().manual_seed(B + geom["N"])
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for rate in (0.0, 0.5):
                for approx in (False, True):
                    tag = f"{geom_name}/B{B}/rate{rate}/{'tanh' if approx else 'erf'}"
                    out = gk.fused_gmlp_block(x, p, seed=7, dropout_rate=rate,
                                              approximate_gelu=approx)
                    want = gk.gmlp_block_reference(x, p, rate, approx, seed=7)
                    report["errors"][f"K3f/{tag}"] = rel_err(torch, [out], [want], f"K3f/{tag}")
                    run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=7, dropout_rate=rate,
                                                          approximate_gelu=approx)
                    dx, grads = run()
                    wdx, wgrads = gk.gmlp_block_bwd_reference(x, g, p, rate, approx, seed=7)
                    report["errors"][f"K3b/{tag}"] = rel_err(torch, (dx, *grads), (wdx, *wgrads),
                                                             f"K3b/{tag}")
                    dx2, grads2 = run()
                    if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                        raise AssertionError(f"K3b/{tag}: two backward runs differ")
            for m, mask in enumerate(gk.gmlp_masks(7, B, geom["N"], geom["D"], geom["F"], 0.5,
                                                   "cuda")):
                share = (mask > 0).float().mean().item()
                report.setdefault("kept_share", {})[f"gmlp/{geom_name}/B{B}/mask{m}"] = share
                if not abs(share - 0.5) <= 0.01:
                    raise AssertionError(f"gMLP mask {m}: kept share {share} is not 0.5 +- 0.01")
            print(f"  kept shares of the three masks, {geom_name} B={B}: " + ", ".join(
                f"{report['kept_share'][f'gmlp/{geom_name}/B{B}/mask{m}']:.4f}" for m in range(3)))


def phase_gmlp_serving(torch, gk, serving, np, report):
    print("[8/16] serving the gMLP config through serving export --pallas (K3f)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_") as tmp:
        plain_dir, kernel_dir = os.path.join(tmp, "plain"), os.path.join(tmp, "kernel")
        serving.main(["export", "-c", GMLP_CFG, "-o", plain_dir])
        serving.main(["export", "-c", GMLP_CFG, "-p", os.path.join(plain_dir, "weights.npz"),
                      "-o", kernel_dir, "--pallas"])
        plain, kernel = serving.load_serving(plain_dir), serving.load_serving(kernel_dir)
    if kernel.meta["block_flavor"] != "kernel" or plain.meta["block_flavor"] != "plain":
        raise AssertionError("the gMLP artifacts are not plain and kernel-backed")
    rng = np.random.RandomState(2)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    # the main path: the counter zeroed just before, read just after
    gk.fused_gmlp_block.launches = 0
    answers = {n: kernel.predict(feats) for n, feats in requests.items()}
    launches = gk.fused_gmlp_block.launches
    print(f"  main-path launches: K3f {launches}")
    if launches <= 0:
        raise AssertionError("K3f was never launched on the gMLP serving path")
    worst, worst_rel = 0.0, 0.0
    for n, got in answers.items():
        want = plain.predict(requests[n])
        for g, w in [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                                   want["branch_logits"])):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"gMLP n={n}: bad output {g.shape} vs {w.shape}")
            err, scale = float(np.abs(g - w).max()), max(1.0, float(np.abs(w).max()))
            if not err <= SERVED_REL * scale:
                raise AssertionError(f"gMLP n={n}: logits differ by {err} > {SERVED_REL} x {scale}")
            worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        print(f"  request of {n}: logits {got['logits'].shape}, worst |err| so far {worst:.3e} "
              f"({worst_rel:.2e} of max(1, max|plain|))")
    report["gmlp_served_max_abs_err"] = worst
    report["gmlp_served_max_rel_err"] = worst_rel
    report["gmlp_serving_launches"] = launches
    return plain, kernel


def gmlp_zero(gk):
    gk.fused_gmlp_block.launches = gk.fused_gmlp_block_bwd.launches = 0


def gmlp_counters(gk):
    return {"K3f": gk.fused_gmlp_block.launches, "K3b": gk.fused_gmlp_block_bwd.launches}


def gmlp_train_args(tmp, name, kernel):
    return ["-c", GMLP_CFG, "-n", name, f"train.tensorboard_path={tmp}", "train.epochs=2",
            "dataset.params.synthetic=true", "dataset.params.synthetic_learnable=true",
            f"dataset.params.synthetic_sizes={TRAIN_SIZES}",
            *(GMLP_KERNEL_BLOCKS if kernel else [])]


def phase_gmlp_training(torch, gk, serving, run, apply_overrides, load_cfg, synthetic, np,
                        report):
    print("[11/16] training the gMLP config through PallasVisiongMLP / PallasFusiongMLP")
    cfg = load_cfg(GMLP_CFG)
    apply_overrides(cfg, ["model.dropout=0.0", *GMLP_NO_DEPTH_DROP], warn=False)
    plain = serving._build_task(cfg, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic(32, seed=3, learnable=True).items()}
    p_losses, p_grads = train_step_one(torch, plain, batch)
    kernel, _ = serving.to_torch_kernel_serving(cfg, plain.network.state_dict(), device="cuda")
    gmlp_zero(gk)
    k_losses, k_grads = train_step_one(torch, kernel, batch)
    if not all(gmlp_counters(gk).values()):
        raise AssertionError("gMLP step 1 did not launch K3f and K3b")
    want = serving.to_torch_kernel_serving(cfg, p_grads, device="cuda")[1]
    if set(want) != set(k_grads):
        raise AssertionError("gMLP: gradient names differ")
    names = sorted(k_grads)
    key = "gMLP train step 1: loss, branch losses"
    report["errors"][key] = rel_err(torch, k_losses, p_losses, key)
    key = f"gMLP train step 1: {len(names)} parameter gradients"
    report["errors"][key] = rel_err(torch, [k_grads[n] for n in names],
                                    [want[n].cuda() for n in names], key)
    del plain, kernel

    runs = report["gmlp_training_runs"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_train_") as tmp:
        for flavor in ("plain", "kernel"):
            runs[flavor] = train_run(
                run, np, gmlp_train_args(tmp, f"smoke_gmlp_{flavor}", flavor == "kernel"),
                lambda: gmlp_zero(gk), lambda: gmlp_counters(gk), f"gMLP {flavor}", GMLP_MIN_ACC)
    for name, count in runs["kernel"]["launches"].items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the gMLP training path")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError("the plain-module gMLP run launched a gMLP kernel")
    report["gmlp_training_launches"] = runs["kernel"]["launches"]


def phase_gmlp_times(torch, gk, serving, Trainer, apply_overrides, load_cfg, synthetic, np,
                     served, report):
    print("[14/16] gMLP times (CUDA events, median of 5 runs)")
    times, bounds = report["times_ms"], report["bounds_ms"]
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        p = gmlp_params(gk, torch, seed=33, **geom)
        for B in (32, 512):
            tag = f"{geom_name}/B{B}"
            gen = torch.Generator().manual_seed(6)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            times[f"K3f/{tag}"] = cuda_ms(torch, lambda: gk.fused_gmlp_block(x, p))
            times[f"K3f_plain/{tag}"] = cuda_ms(torch, lambda: gk.gmlp_block_reference(x, p))
            times[f"K3b/{tag}"] = cuda_ms(torch, lambda: gk.fused_gmlp_block_bwd(x, g, p))
            times[f"K3b_plain/{tag}"] = cuda_ms(torch, lambda: gk.gmlp_block_bwd_reference(x, g, p))
            if B == 512:
                calls = [("K3f", lambda: gk.fused_gmlp_block(x, p)),
                         ("K3b", lambda: gk.fused_gmlp_block_bwd(x, g, p))]
                for name, fn in calls:
                    report.setdefault("breakdown_us", {})[f"{name}/{tag}"] = kernel_breakdown(
                        torch, fn, f"{name} {tag}")
            flops, pbytes = gmlp_work(B, **geom)
            act = B * geom["N"] * geom["D"] * 4
            bounds[f"K3f/{tag}"] = bound(flops, pbytes + 2 * act, "f32")
            bounds[f"K3b/{tag}"] = bound(2 * flops, 2 * pbytes + 3 * act, "f32")
            tc = report.setdefault("bounds_3xtf32_ms", {})
            tc[f"K3f/{tag}"] = flops / TC_3XTF32 * 1e3
            tc[f"K3b/{tag}"] = 2 * flops / TC_3XTF32 * 1e3
            print(f"  {tag}: K3f {times[f'K3f/{tag}']:.4f} ms (plain "
                  f"{times[f'K3f_plain/{tag}']:.4f}, bound {bounds[f'K3f/{tag}'][0]:.4f}, 3xTF32 "
                  f"bound {tc[f'K3f/{tag}']:.4f}); K3b "
                  f"{times[f'K3b/{tag}']:.4f} ms (plain {times[f'K3b_plain/{tag}']:.4f}, bound "
                  f"{bounds[f'K3b/{tag}'][0]:.4f}, 3xTF32 bound "
                  f"{report['bounds_3xtf32_ms'][f'K3b/{tag}']:.4f})")
    rng = np.random.RandomState(3)
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        for k, m in served.items():
            times[f"gmlp_served/{k}/B{B}"] = cuda_ms(torch, lambda: m.forward_device(feats),
                                                     iters=5)
        print(f"  served forward B={B}: " + ", ".join(
            f"{k} {times[f'gmlp_served/{k}/B{B}']:.4f} ms" for k in served))
    gk.fused_gmlp_block.launches = 0
    served["kernel"].forward_device(feats)
    report["gmlp_launches_per_forward"] = gk.fused_gmlp_block.launches
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_steps_") as tmp:
        for flavor in ("plain", "kernel"):
            cfg = load_cfg(GMLP_CFG)
            apply_overrides(cfg, GMLP_KERNEL_BLOCKS if flavor == "kernel" else [], warn=False)
            task = serving._build_task(cfg, device="cuda")
            trainer = Trainer(cfg.train, name=f"gmlp_steps_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            for B in (32, 512):
                batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                torch.cuda.reset_peak_memory_stats()
                times[f"gmlp_train_step/{flavor}/B{B}"] = cuda_ms(
                    torch, lambda: trainer.train_step(task, batch, ctx), iters=3)
                report.setdefault("gmlp_train_step_peak_gib", {})[f"{flavor}/B{B}"] = \
                    torch.cuda.max_memory_allocated() / 2**30
            trainer.logger.close()
            del task, trainer
    print("  train step (the unchanged config: dropout 0, stochastic depth on, the same "
          "draws on both sides): " + ", ".join(
              f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
              if k.startswith("gmlp_train_step/")))
    print(f"  peak memory of the train steps (GiB): {report['gmlp_train_step_peak_gib']}")


# ------------------------------------------------------------ the bf16 gMLP
# which of dx and a gMLP block's 10 gradients bf16 compute rounds to bf16 (the
# transposes of its casts): all but b_in, sgu_b and b_out, which add in float32
GMLP_ROUNDED = (True, True, True, True, False, True, True, True, False, True, False)
GMLP_BF16_RATES = (0.0, 0.1)
GMLP_BF16_REQUESTS = (1, 7, 32, 100)  # the same artifact on the CPU: 75 blocks a sample


def gmlp_bf16_counters(gk):
    return {"K3f_bf16": gk.fused_gmlp_block.bf16_launches,
            "K3b_bf16": gk.fused_gmlp_block_bwd.bf16_launches}


def gmlp_bf16_zero(gk):
    gk.fused_gmlp_block.bf16_launches = gk.fused_gmlp_block_bwd.bf16_launches = 0


def phase_gmlp_bf16_kernels(torch, gk, report):
    """bf16 K3f against the plain bf16 version (bf16_err) and bf16 K3b against
    its autograd (bf16_grad_check, at most 10% of the rounded elements
    differing) at the config's shapes, batch 32 and 512, dropout 0 and 0.1,
    each with its float32-math control; the plain bf16 version on the CPU as
    the second implementation at batch 32; two backward runs bit-identical."""
    print("[5/16] K3f / K3b in bf16 compute vs the plain bf16 version and its autograd "
          "(float32 parameters, rounded where _block_math casts them)")
    bf16 = torch.bfloat16
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        p = gmlp_params(gk, torch, seed=35, **geom)
        for B in (32, 512):
            gen = torch.Generator().manual_seed(B + geom["N"] + 1)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for rate in GMLP_BF16_RATES:
                tag = f"{geom_name}/B{B}/rate{rate}"
                got, counts = tallied(torch, lambda: gk.fused_gmlp_block(
                    x, p, seed=9, dropout_rate=rate, compute_dtype=bf16))
                check_wg_route(counts, f"K3f_bf16/{tag}", {"K3f": 1})
                want = gk.gmlp_block_reference(x, p, rate, seed=9, compute_dtype=bf16)
                control = round_bf16(torch, gk.gmlp_block_reference(x, p, rate, seed=9))
                report["errors"][f"K3f_bf16/{tag}"] = bf16_err(torch, got, want, control,
                                                               f"K3f_bf16/{tag}", report)
                run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=9, dropout_rate=rate,
                                                      compute_dtype=bf16)
                (dx, grads), counts = tallied(torch, run)
                check_wg_route(counts, f"K3b_bf16/{tag}", {"K3b": 1})
                wdx, wgrads = gk.gmlp_block_bwd_reference(x, g, p, rate, seed=9,
                                                          compute_dtype=bf16)
                fdx, fgrads = gk.gmlp_block_bwd_reference(x, g, p, rate, seed=9)
                control = [round_bf16(torch, t) if r else t
                           for t, r in zip((fdx, *fgrads), GMLP_ROUNDED)]
                cpu = None
                if B == 32:
                    c = gk.gmlp_block_bwd_reference(x.cpu(), g.cpu(), [t.cpu() for t in p], rate,
                                                    seed=9, compute_dtype=bf16)
                    cpu = (c[0], *c[1])
                report["errors"][f"K3b_bf16/{tag}"] = bf16_grad_check(
                    torch, (dx, *grads), (wdx, *wgrads), control, cpu, GMLP_ROUNDED,
                    BF16_GRAD_SHARE["K1b"], f"K3b_bf16/{tag}", report)
                dx2, grads2 = run()
                if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                    raise AssertionError(f"K3b_bf16/{tag}: two backward runs differ")


# the widths this slice repaired: hidden widths the mixer kernels pad (no
# multiple of 8, in float32 at 30 of 4) at the B shapes' N, T and C; the gMLP
# block at F = 4096, whose LN(v) rows outgrew the fixed row tile
WIDTH_GEOMS = {"d20": dict(N=4, D=20, T=32, C=3072), "d30": dict(N=8, D=30, T=32, C=3078)}
GMLP_WIDE = dict(N=49, D=128, F=4096)


def phase_mixer_widths(torch, mk, report):
    """K1f, K2f (4 blocks + LN), K1b and K2b at hidden widths the kernels pad
    (WIDTH_GEOMS), batch 64, dropout 0.5, against the plain versions and their
    autograd: float32 (max_err, grad_err) and bf16 (bf16_err, bf16_grad_check,
    each with its float32-math control); two runs bit-identical."""
    print("[4/16] K1f / K2f / K1b / K2b at hidden widths the kernels pad (D = 20 and 30), "
          "float32 and bf16")
    for name, geom in WIDTH_GEOMS.items():
        blocks, s, b = rand_blocks(mk, torch, 4, seed=61, **geom)
        flat = mk.stack_flat_params(blocks, s, b)
        gen = torch.Generator().manual_seed(64)
        x = torch.randn(64, geom["N"], geom["D"], generator=gen).cuda()
        g = torch.randn(64, geom["N"], geom["D"], generator=gen).cuda()
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            fwd = {"K1f": (lambda: mk.fused_mixer_block(x, blocks[0], 3, 0.5, cd),
                           lambda c: mk.mixer_block_reference(x, blocks[0], 0.5, c, seed=3)),
                   "K2f": (lambda: mk.fused_mixer_stack(x, flat, 4, 0.5, cd),
                           lambda c: mk.mixer_stack_reference(x, flat, c, dropout_rate=0.5,
                                                              seed=4))}
            for kernel, (run, plain) in fwd.items():
                key = f"{kernel}/{name}/{dtype}"
                got = run()
                if dtype == "f32":
                    report["errors"][key] = max_err(torch, got, plain(cd), key)
                else:
                    report["errors"][key] = bf16_err(torch, got, plain(cd),
                                                     round_bf16(torch, plain(torch.float32)), key,
                                                     report)
                if not torch.equal(got, run()):
                    raise AssertionError(f"{key}: two runs differ")
            bwd = {"K1b": (lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 3, 0.5, cd),
                           lambda c: mk.mixer_block_bwd_reference(x, g, blocks[0], 0.5, c, seed=3),
                           (True, *BF16_ROUNDED), BF16_GRAD_SHARE["K1b"]),
                   "K2b": (lambda: mk.fused_mixer_stack_bwd(x, g, flat, 4, 0.5, cd),
                           lambda c: mk.mixer_stack_bwd_reference(x, g, flat, 0.5, c, seed=4),
                           (True, *(BF16_ROUNDED * 4), True, True), BF16_GRAD_SHARE["K2b"])}
            for kernel, (run, plain, rounded, share) in bwd.items():
                key = f"{kernel}/{name}/{dtype}"
                dx, grads = run()
                want = plain(cd)
                if dtype == "f32":
                    report["errors"][key] = grad_err(torch, (dx, *grads), (want[0], *want[1]),
                                                     key)
                else:
                    f32 = plain(torch.float32)
                    control = [round_bf16(torch, t) if r else t
                               for t, r in zip((f32[0], *f32[1]), rounded)]
                    report["errors"][key] = bf16_grad_check(
                        torch, (dx, *grads), (want[0], *want[1]), control, None, rounded, share,
                        key, report)
                dx2, grads2 = run()
                if not all(torch.equal(u, v) for u, v in zip((dx, *grads), (dx2, *grads2))):
                    raise AssertionError(f"{key}: two backward runs differ")


def phase_gmlp_widths(torch, gk, report):
    """K3f / K3b at F = 4096 (GMLP_WIDE, batch 32, dropout 0.1) against the
    plain version and its autograd: float32 (rel_err) and bf16 (bf16_err,
    bf16_grad_check with their float32-math controls; every product on the
    engine by the launch tallies); two backward runs bit-identical."""
    print("[5/16] K3f / K3b at F = 4096 (LN(v)'s rows on a row tile sized from the shared "
          "memory), float32 and bf16")
    p = gmlp_params(gk, torch, seed=37, **GMLP_WIDE)
    gen = torch.Generator().manual_seed(4096)
    x = torch.randn(32, GMLP_WIDE["N"], GMLP_WIDE["D"], generator=gen).cuda()
    g = torch.randn(32, GMLP_WIDE["N"], GMLP_WIDE["D"], generator=gen).cuda()
    for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        key = f"F4096/B32/{dtype}"
        got, counts = tallied(torch, lambda: gk.fused_gmlp_block(x, p, seed=9, dropout_rate=0.1,
                                                                 compute_dtype=cd))
        want = gk.gmlp_block_reference(x, p, 0.1, seed=9, compute_dtype=cd)
        run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=9, dropout_rate=0.1,
                                              compute_dtype=cd)
        (dx, grads), bcounts = tallied(torch, run)
        wdx, wgrads = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=9, compute_dtype=cd)
        if dtype == "f32":
            report["errors"][f"K3f/{key}"] = rel_err(torch, [got], [want], f"K3f/{key}")
            report["errors"][f"K3b/{key}"] = rel_err(torch, (dx, *grads), (wdx, *wgrads),
                                                     f"K3b/{key}")
        else:
            check_wg_route(counts, f"K3f/{key}", {"K3f": 1})
            check_wg_route(bcounts, f"K3b/{key}", {"K3b": 1})
            control = round_bf16(torch, gk.gmlp_block_reference(x, p, 0.1, seed=9))
            report["errors"][f"K3f/{key}"] = bf16_err(torch, got, want, control, f"K3f/{key}",
                                                      report)
            fdx, fgrads = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=9)
            control = [round_bf16(torch, t) if r else t
                       for t, r in zip((fdx, *fgrads), GMLP_ROUNDED)]
            report["errors"][f"K3b/{key}"] = bf16_grad_check(
                torch, (dx, *grads), (wdx, *wgrads), control, None, GMLP_ROUNDED,
                BF16_GRAD_SHARE["K1b"], f"K3b/{key}", report)
        dx2, grads2 = run()
        if not all(torch.equal(u, v) for u, v in zip((dx, *grads), (dx2, *grads2))):
            raise AssertionError(f"K3b/{key}: two backward runs differ")


def gmlp_bf16_args(tmp, name, kernel):
    return [*gmlp_train_args(tmp, name, kernel), "model.precision=bf16"]


def phase_gmlp_bf16_training(torch, gk, serving, run, apply_overrides, load_cfg, synthetic, np,
                             report, tmp):
    """The gMLP config at ``model.precision=bf16``, full width and depth: step 1
    through the kernel blocks (dropout 0, stochastic depth pinned off) on the
    card against the CPU at the config's batch 32; 2-epoch runs with the plain
    bf16 modules and with the kernel blocks (bf16 K3f/K3b); the plain run's
    weights through ``serving export --pallas`` (bf16 K3f), the card's artifact
    against the same artifact on the CPU. Returns the plain and the kernel
    artifact (for the times)."""
    print("[11/16] the gMLP config in bf16 (model.precision=bf16) through PallasVisiongMLP / "
          "PallasFusiongMLP: step 1 on the card against the CPU, 2-epoch runs, export --pallas")
    cfg = load_cfg(GMLP_CFG)
    apply_overrides(cfg, ["model.precision=bf16", "model.dropout=0.0", *GMLP_NO_DEPTH_DROP,
                          *GMLP_KERNEL_BLOCKS], warn=False)
    task = serving._build_task(cfg, device="cuda")
    cpu = serving._build_task(cfg, device="cpu")
    cpu.network.load_state_dict(task.network.state_dict())
    batch = synthetic(32, seed=3, learnable=True)
    gmlp_bf16_zero(gk)
    (g_losses, g_grads), counts = tallied(torch, lambda: train_step_one(
        torch, task, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}))
    launched = gmlp_bf16_counters(gk)
    check_wg_route(counts, "gMLP bf16 step 1", {"K3f": launched["K3f_bf16"],
                                                         "K3b": launched["K3b_bf16"]})
    c_losses, c_grads = train_step_one(torch, cpu, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    if not all(launched.values()):
        raise AssertionError(f"gMLP bf16 step 1 did not launch bf16 K3f and K3b: {launched}")
    key = "gMLP bf16 step 1: loss, branch losses"
    report["errors"][key] = rel_err(torch, torch.stack(g_losses).cpu(), torch.stack(c_losses),
                                    key, BF16_REL)
    names = sorted(g_grads)
    key = f"gMLP bf16 step 1: {len(names)} parameter gradients"
    report["errors"][key] = rel_err(torch, [g_grads[n].cpu() for n in names],
                                    [c_grads[n] for n in names], key, BF16_REL)
    if not all(p.dtype == torch.float32 for p in task.network.parameters()):
        raise AssertionError("the bf16 gMLP kernel blocks hold parameters that are not float32")
    del task, cpu, g_grads, c_grads
    torch.cuda.empty_cache()

    from m2mixer_tpu_torch.ops import _build

    runs = report["gmlp_bf16_training_runs"] = {}
    tally = {}
    for flavor in ("plain", "kernel"):
        def zero():
            gmlp_bf16_zero(gk)
            tally["before"] = _build.launch_tally()

        def read():
            after = _build.launch_tally()
            tally[flavor] = {k: after[k] - tally["before"][k] for k in after}
            return gmlp_bf16_counters(gk)

        runs[flavor] = train_run(
            run, np, gmlp_bf16_args(tmp, f"gmlp_bf16_{flavor}", flavor == "kernel"), zero, read,
            f"gMLP bf16 {flavor}", 0.0)
        torch.cuda.empty_cache()
    check_wg_route(tally["kernel"], "gMLP bf16 kernel run",
                            {"K3f": runs["kernel"]["launches"]["K3f_bf16"],
                             "K3b": runs["kernel"]["launches"]["K3b_bf16"]})
    if any(runs["plain"]["launches"].values()):
        raise AssertionError("the plain bf16 gMLP run launched a gMLP kernel")
    for name, count in runs["kernel"]["launches"].items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the bf16 gMLP training path")
    # the float32 runs' gate; where the plain bf16 modules miss it on this card
    # too, the kernel run is held to the plain bf16 run's accuracy - 0.1
    acc = {f: min(r["val_acc"][-1], r["test_acc"]) for f, r in runs.items()}
    gate = GMLP_MIN_ACC if acc["plain"] >= GMLP_MIN_ACC else acc["plain"] - 0.1
    print(f"  accuracy (min of last val, test): plain bf16 {acc['plain']:.4f}, kernel blocks "
          f"{acc['kernel']:.4f} (gate {gate:.4f})")
    report["gmlp_bf16_acc_gate"] = gate
    if not acc["kernel"] >= gate:
        raise AssertionError(f"the bf16 gMLP kernel run's accuracy {acc['kernel']} < {gate}")
    report["gmlp_bf16_training_launches"] = runs["kernel"]["launches"]

    print("[11/16] serving the trained bf16 gMLP weights (the plain run's) through serving "
          "export --pallas (bf16 K3f) against the same artifact on the CPU")
    log_root = os.path.join(tmp, "gmlp_bf16_plain")
    weights = os.path.join(log_root, sorted(os.listdir(log_root))[-1], "checkpoints",
                           "best.npz")
    plain_dir, kernel_dir = os.path.join(tmp, "gmlp_bf16_art"), os.path.join(tmp, "gmlp_bf16_k")
    serving.main(["export", "-c", GMLP_CFG, "-p", weights, "-o", plain_dir,
                  "model.precision=bf16"])
    serving.main(["export", "-c", GMLP_CFG, "-p", weights, "-o", kernel_dir, "--pallas",
                  "model.precision=bf16"])
    plain, model = serving.load_serving(plain_dir), serving.load_serving(kernel_dir)
    on_cpu = serving.load_serving(kernel_dir, device="cpu")
    if model.meta["block_flavor"] != "kernel" or \
            model.meta["config"]["model"]["precision"] != "bf16":
        raise AssertionError("the bf16 gMLP artifact is not a bf16 kernel artifact")
    rng = np.random.RandomState(2)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)}
                for n in GMLP_BF16_REQUESTS}
    gmlp_bf16_zero(gk)
    answers, counts = tallied(torch, lambda: {n: model.predict(f) for n, f in requests.items()})
    launched = gmlp_bf16_counters(gk)["K3f_bf16"]
    print(f"  main-path launches: bf16 K3f {launched}")
    if launched <= 0:
        raise AssertionError("bf16 K3f was never launched serving the bf16 gMLP")
    check_wg_route(counts, "bf16 gMLP serving", {"K3f": launched})
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))
    worst = to_plain = 0.0
    for n, got in answers.items():
        want, bf = on_cpu.predict(requests[n]), plain.predict(requests[n])
        for gl, wl, bl in [(got["logits"], want["logits"], bf["logits"])] + list(
                zip(got["branch_logits"], want["branch_logits"], bf["branch_logits"])):
            if gl.shape != wl.shape or not np.isfinite(gl).all():
                raise AssertionError(f"bf16 gMLP request of {n}: bad output {gl.shape}")
            worst, to_plain = max(worst, rel(gl, wl)), max(to_plain, rel(gl, bl))
    print(f"  requests of {list(GMLP_BF16_REQUESTS)}: worst |err| / max(1, max|CPU|) "
          f"{worst:.3e} (tol {BF16_REL}); to the plain bf16 artifact {to_plain:.3e}")
    if not worst <= BF16_REL:
        raise AssertionError(f"bf16 gMLP served logits differ from the CPU's by {worst}")
    report["gmlp_bf16_served_rel_err"] = worst
    report["gmlp_bf16_served_to_plain"] = to_plain
    report["gmlp_bf16_serving_launches"] = launched
    return {"plain": plain, "kernel": model}


def phase_gmlp_bf16_times(torch, gk, serving, Trainer, apply_overrides, load_cfg, synthetic, np,
                          served, report):
    """bf16 K3f / K3b alone with their plain versions and bounds (the dense
    bf16 peak; the design's, ``bf16_gmlp_design_ms``: its products on the
    wgmma engine, its other kernels at their bytes), the profiler's
    breakdown of one call of each at batch 512; the bf16 served forward and
    train step, plain modules against the kernel blocks, batch 32 and 512."""
    print("[14/16] bf16 gMLP times (CUDA events, median of 5 runs)")
    times, bounds = report["times_ms"], report["bounds_ms"]
    design = report.setdefault("bounds_design_ms", {})
    bf16 = torch.bfloat16
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        p = gmlp_params(gk, torch, seed=37, **geom)
        for B in (32, 512):
            tag = f"{geom_name}/B{B}"
            gen = torch.Generator().manual_seed(6)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            calls = {
                "K3f_bf16": lambda: gk.fused_gmlp_block(x, p, compute_dtype=bf16),
                "K3f_bf16_plain": lambda: gk.gmlp_block_reference(x, p, compute_dtype=bf16),
                "K3b_bf16": lambda: gk.fused_gmlp_block_bwd(x, g, p, compute_dtype=bf16),
                "K3b_bf16_plain": lambda: gk.gmlp_block_bwd_reference(x, g, p,
                                                                      compute_dtype=bf16)}
            for name, fn in calls.items():
                times[f"{name}/{tag}"] = cuda_ms(torch, fn)
            if B == 512:
                bd = report.setdefault("breakdown_us", {})
                for name in ("K3f_bf16", "K3b_bf16"):
                    bd[f"{name}/{tag}"] = kernel_breakdown(torch, calls[name], f"{name} {tag}")
            flops, pbytes = gmlp_work(B, **geom)
            act = B * geom["N"] * geom["D"] * 4
            # the weights read in bf16 (the kernels read float32 and round them)
            wbytes = pbytes // 2
            bounds[f"K3f_bf16/{tag}"] = bound(flops, wbytes + 2 * act, "bf16")
            bounds[f"K3b_bf16/{tag}"] = bound(2 * flops, wbytes + pbytes + 3 * act, "bf16")
            design[f"K3f_bf16/{tag}"], design[f"K3b_bf16/{tag}"] = bf16_gmlp_design_ms(B, **geom)
            print(f"  {tag}: " + "; ".join(
                f"{n} {times[f'{n}/{tag}']:.4f} ms (plain {times[f'{n}_plain/{tag}']:.4f}, bound "
                f"{bounds[f'{n}/{tag}'][0]:.4f}, bf16_gmlp_design_ms {design[f'{n}/{tag}']:.4f})"
                for n in ("K3f_bf16", "K3b_bf16")))
            del calls
    rng = np.random.RandomState(3)
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        for k, m in served.items():
            times[f"gmlp_bf16_served/{k}/B{B}"] = cuda_ms(torch, lambda: m.forward_device(feats),
                                                          iters=5)
        print(f"  bf16 served forward B={B}: " + ", ".join(
            f"{k} {times[f'gmlp_bf16_served/{k}/B{B}']:.4f} ms" for k in served))
    gmlp_bf16_zero(gk)
    served["kernel"].forward_device(feats)
    report["gmlp_bf16_launches_per_forward"] = gk.fused_gmlp_block.bf16_launches
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_bf16_steps_") as tmp:
        for flavor in ("plain", "kernel"):
            cfg = load_cfg(GMLP_CFG)
            apply_overrides(cfg, ["model.precision=bf16",
                                  *(GMLP_KERNEL_BLOCKS if flavor == "kernel" else [])],
                            warn=False)
            task = serving._build_task(cfg, device="cuda")
            trainer = Trainer(cfg.train, name=f"gmlp_bf16_steps_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            for B in (32, 512):
                batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                torch.cuda.reset_peak_memory_stats()
                times[f"gmlp_bf16_train_step/{flavor}/B{B}"] = cuda_ms(
                    torch, lambda: trainer.train_step(task, batch, ctx), iters=3)
                report.setdefault("gmlp_bf16_train_step_peak_gib", {})[f"{flavor}/B{B}"] = \
                    torch.cuda.max_memory_allocated() / 2**30
            trainer.logger.close()
            del task, trainer
            torch.cuda.empty_cache()
    print("  bf16 train step (the config otherwise unchanged: dropout 0, stochastic depth on): "
          + ", ".join(f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
                      if k.startswith("gmlp_bf16_train_step/")))


# ----------------------------------------------------------------- DynaMixer
def dyna_params(dk, torch, L, C, H, R, seed):
    """One DynaMixerOp's parameters at the Linear layers' init scales,
    U(+-1/sqrt(fan_in)), on the card; the weights output-major, as
    DynaMixerOp hands them over."""
    g = torch.Generator().manual_seed(seed)
    u = lambda fan, *shape: (torch.rand(*shape, generator=g) * 2 - 1) / fan ** 0.5
    p = (u(C, H * R, C), u(C, H * R), u(L * R, L * L, L * R), u(L * R, L * L), u(C, C, C),
         u(C, C))
    return dk.DynaMixerOpParams(*(t.cuda() for t in p))


def dyna_logit_range(x, p, H, R) -> float:
    """max |generate logit| of the op at x (what the softmax sees)."""
    S, L, C = x.shape
    w = (x.reshape(S * L, C) @ p.w_compress.t() + p.b_compress).reshape(S, L, H, R)
    w = w.transpose(1, 2).reshape(S * H, L * R)
    return (w @ p.w_generate.t() + p.b_generate).abs().max().item()


def dyna_work(S, L, C, H, R):
    """(forward flops, parameter bytes) of one DynaMixerOp over S sequences in
    float32: compress, generate, the per-head mix, the output projection."""
    HR, LR, LL = H * R, L * R, L * L
    flops = S * (2 * L * C * HR + 2 * H * LR * LL + 2 * H * LL * (C // H) + 2 * L * C * C)
    params = C * HR + HR + LR * LL + LL + C * C + C
    return flops, 4 * params


def phase_dyna_kernels(torch, dk, report):
    print("[6/16] K4f / K4b fused DynaMixerOp vs the plain version and its autograd")
    H, R = DYNA_OP["H"], DYNA_OP["R"]
    p = dyna_params(dk, torch, seed=41, **DYNA_OP)
    for B in (32, 512):
        gen = torch.Generator().manual_seed(B)
        shape = (7 * B, DYNA_OP["L"], DYNA_OP["C"])
        x1 = torch.randn(*shape, generator=gen).cuda()
        g = torch.randn(*shape, generator=gen).cuda()
        for scale in (1, 30):  # x30: generate logits of tens, the softmax's stress case
            tag = f"B{B}/x{scale}"
            x = scale * x1
            logits = dyna_logit_range(x, p, H, R)
            report.setdefault("dyna_max_abs_logit", {})[tag] = logits
            print(f"  {tag}: max |generate logit| {logits:.1f}")
            out = dk.fused_dynamixer_op(x, p, H, R)
            report["errors"][f"K4f/{tag}"] = rel_err(
                torch, [out], [dk.dynamixer_op_reference(x, p, H, R)], f"K4f/{tag}")
            run = lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R)
            dx, grads = run()
            wdx, wgrads = dk.dynamixer_op_bwd_reference(x, g, p, H, R)
            report["errors"][f"K4b/{tag}"] = rel_err(torch, (dx, *grads), (wdx, *wgrads),
                                                     f"K4b/{tag}")
            dx2, grads2 = run()
            if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                raise AssertionError(f"K4b/{tag}: two backward runs differ")
    # the lifted shapes
    for name, geom in DYNA_LIFTED.items():
        L, C, Hh, Rr = (geom[k] for k in "LCHR")
        pl = dyna_params(dk, torch, seed=42, **geom)
        gen = torch.Generator().manual_seed(L)
        x = torch.randn(DYNA_LIFTED_S, L, C, generator=gen).cuda()
        g = torch.randn(DYNA_LIFTED_S, L, C, generator=gen).cuda()
        out = dk.fused_dynamixer_op(x, pl, Hh, Rr)
        report["errors"][f"K4f/{name}"] = rel_err(
            torch, [out], [dk.dynamixer_op_reference(x, pl, Hh, Rr)], f"K4f/{name} {geom}")
        dx, grads = dk.fused_dynamixer_op_bwd(x, g, pl, Hh, Rr)
        wdx, wgrads = dk.dynamixer_op_bwd_reference(x, g, pl, Hh, Rr)
        report["errors"][f"K4b/{name}"] = rel_err(torch, (dx, *grads), (wdx, *wgrads),
                                                  f"K4b/{name} {geom}")
        if not torch.equal(out, dk.fused_dynamixer_op(x, pl, Hh, Rr)):
            raise AssertionError(f"K4f/{name}: two runs differ")


def phase_error_rows(torch, mk, gk, dk, lib, report):
    """K1b (encoder and fusion shape), K3b (encoder shape) and K4b at batch
    2048 and 4096 against autograd of the plain versions on the card: each
    tensor's error relative to max(1, max|plain|), beside the rows of the
    slices the plan sums dW3/dW4 (dW_in/dW_out, dW_o/dW_c) over. Held to the
    unchanged gates (K1b: the mixer's, with its exactly-zero gradient)."""
    print("[6/16] 3xTF32 error against rows: K1b (encoder and fusion shape), K3b (encoder "
          f"shape) and K4b at batch {' and '.join(map(str, ROWS_BATCHES))}; the bf16 wgmma "
          "engine's products against float64")
    out = report["error_vs_rows"] = {}

    def record(key, names, a, b, rslice, rows):
        rel = {n: (u - v).abs().max().item() / max(1.0, v.abs().max().item())
               for n, u, v in zip(names, a, b)}
        near = max(rel.values()) >= GRAD_REL / 2
        out[key] = {"rows": rows, "row_slice": rslice, "rel_err": rel, "within_2x_of_gate": near}
        print(f"  {key}: {rows} rows, slices of {rslice} rows; error / max(1, max|plain|): "
              + ", ".join(f"{n} {e:.2e}" for n, e in rel.items())
              + (" (within 2x of the gate: shorten the slices)" if near else ""))

    names1 = ["dx", *mk.MixerBlockParams._fields]
    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        blocks, _, _ = rand_blocks(mk, torch, 1, seed=25, **geom)
        for B in ROWS_BATCHES:
            gen = torch.Generator().manual_seed(B)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            got = mk.fused_mixer_block_bwd(x, g, blocks[0])
            want = mk.mixer_block_bwd_reference(x, g, blocks[0])
            a, b = (got[0], *got[1]), (want[0], *want[1])
            key = f"K1b/{geom_name}/B{B}"
            rslice = lib.m2m_mixer_row_slice(B, geom["N"], geom["T"], geom["D"], geom["C"], 0)
            record(key, names1, a, b, rslice, B * geom["N"])
            grad_err(torch, a, b, key)
            del got, want, a, b, x, g
            torch.cuda.empty_cache()
    # the L token shapes at batch 512: dW1 and dW2 sum B*D = 262144 rows in
    # slices (m2m_mixer_token_row_slice), dW3 and dW4 the B*N rows
    for geom_name, geom, _ in L_GEOMS[1:]:
        blocks, _, _ = rand_blocks(mk, torch, 1, seed=27, **geom)
        B = 512
        gen = torch.Generator().manual_seed(B)
        x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
        g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
        got = mk.fused_mixer_block_bwd(x, g, blocks[0])
        want = mk.mixer_block_bwd_reference(x, g, blocks[0])
        a, b = (got[0], *got[1]), (want[0], *want[1])
        dims = (B, geom["N"], geom["T"], geom["D"], geom["C"], 0)
        key = f"K1b/L/{geom_name}/B{B}"
        record(key + " token", ["dW1", "dW2"], (a[3], a[5]), (b[3], b[5]),
               lib.m2m_mixer_token_row_slice(*dims), B * geom["D"])
        record(key + " channel", ["dW3", "dW4"], (a[9], a[11]), (b[9], b[11]),
               lib.m2m_mixer_row_slice(*dims), B * geom["N"])
        grad_err(torch, a, b, key)
        del got, want, a, b, x, g
        torch.cuda.empty_cache()
    engine_errors(torch, lib, report)
    names3 = ["dx", *gk.GmlpBlockParams._fields]
    names4 = ["dx", *dk.DynaMixerOpParams._fields]
    p3 = gmlp_params(gk, torch, seed=35, **GMLP_ENC)
    p4 = dyna_params(dk, torch, seed=45, **DYNA_OP)
    H, R = DYNA_OP["H"], DYNA_OP["R"]
    for B in ROWS_BATCHES:
        gen = torch.Generator().manual_seed(B)
        N, D, F = GMLP_ENC["N"], GMLP_ENC["D"], GMLP_ENC["F"]
        x = torch.randn(B, N, D, generator=gen).cuda()
        g = torch.randn(B, N, D, generator=gen).cuda()
        got = gk.fused_gmlp_block_bwd(x, g, p3)
        want = gk.gmlp_block_bwd_reference(x, g, p3)
        cases = [("K3b", names3, (got[0], *got[1]), (want[0], *want[1]),
                  lib.m2m_gmlp_row_slice(B, N, D, F, 0), B * N)]
        del got, want, x, g
        S = 7 * B
        x = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        g = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        got = dk.fused_dynamixer_op_bwd(x, g, p4, H, R)
        want = dk.dynamixer_op_bwd_reference(x, g, p4, H, R)
        cases.append(("K4b", names4, (got[0], *got[1]), (want[0], *want[1]),
                      lib.m2m_dyna_row_slice(S, *DYNA_OP.values(), 0), S * DYNA_OP["L"]))
        for kernel, names, a, b, rslice, rows in cases:
            record(f"{kernel}/B{B}", names, a, b, rslice, rows)
            rel_err(torch, a, b, f"{kernel}/B{B}")
        del got, want, x, g, cases
        torch.cuda.empty_cache()


def engine_errors(torch, lib, report) -> None:
    """The bf16 route's products alone (``m2m_wg_product``: the wgmma engine
    in the layouts the bf16 kernels run them in, the whole depth in one slice)
    at the L fusion shape, batch 512 (R = 40960 rows, D 512, C 4096; the token
    FF's B*D = 262144 rows, N 80, T 256), on operands drawn as the block's:
    K1b's five channel products (z, W3, W4^T and h2 bf16, da4 bf16 times a
    keep bit, da3 float32 as its three bf16 planes) and K1f's four (up: z
    W3, down: h2 W4, the token FF's up: yt W1 and down: ht W2, every operand
    bf16); then bf16 K3f's and K3b's six at the gMLP fusion shape, batch 512
    (R = 50688 rows, D 128, F 768), in their tiles (128 x 64 for the in- and
    out-projection and dgated): in: xn W_in, out: gated W_out, dgated: dout
    W_out^T (dout bf16 times a keep bit), dxn: dpre W_in^T and dW_in: xn^T
    dpre (dpre float32 as its three planes), dW_out: gated^T dout. Each
    output's error against the float64 product of the same values (for dz,
    dW3, dxn and dW_in: of the float32 cotangent, so the split's own error
    counts), relative to its largest magnitude."""
    geom = L_GEOMS[2][1]
    R, D, C = 512 * geom["N"], geom["D"], geom["C"]
    gen = torch.Generator(device="cuda").manual_seed(29)
    bf = torch.bfloat16
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    z = rand(R, D).to(bf)
    w3, w4t = (rand(D, C) / D ** 0.5).to(bf), (rand(D, C) / C ** 0.5).to(bf)
    da4 = (rand(R, D) * (torch.rand(R, D, generator=gen, device="cuda") < 0.5)).to(bf)
    h2 = torch.nn.functional.gelu(rand(R, C)).to(bf)
    da3 = rand(R, C) * 1e-3
    planes = [da3.to(bf)]
    planes.append((da3 - planes[0].float()).to(bf))
    planes.append((da3 - planes[0].float() - planes[1].float()).to(bf))
    w4 = (rand(C, D) / C ** 0.5).to(bf)
    rows, N, T = 512 * D, geom["N"], geom["T"]
    yt, w1 = rand(rows, N).to(bf), (rand(N, T) / N ** 0.5).to(bf)
    ht, w2 = torch.nn.functional.gelu(rand(rows, T)).to(bf), (rand(T, N) / T ** 0.5).to(bf)
    # (A planes, A K-major, B planes, B K-major, M, N, K, float64 reference)
    cases = {"a3": ([z], 1, [w3], 0, R, C, D, lambda: z.double() @ w3.double()),
             "dh2": ([da4], 1, [w4t], 0, R, C, D, lambda: da4.double() @ w4t.double()),
             "dz": (planes, 1, [w3], 1, R, D, C, lambda: da3.double() @ w3.double().t()),
             "dW3": ([z], 0, planes, 0, D, C, R, lambda: z.double().t() @ da3.double()),
             "dW4^T": ([da4], 0, [h2], 0, D, C, R, lambda: da4.double().t() @ h2.double()),
             "up": ([z], 1, [w3], 0, R, C, D, lambda: z.double() @ w3.double()),
             "down": ([h2], 1, [w4], 0, R, D, C, lambda: h2.double() @ w4.double()),
             "token up": ([yt], 1, [w1], 0, rows, T, N, lambda: yt.double() @ w1.double()),
             "token down": ([ht], 1, [w2], 0, rows, N, T, lambda: ht.double() @ w2.double())}
    out = report.setdefault("engine_rel_err", {})
    run_engine_cases(torch, lib, cases, {}, "L_fusion/B512", out)
    print("  the wgmma engine's products (K1b's five, K1f's four) at the L fusion shape, batch "
          "512, error / max|float64|: " + ", ".join(f"{k.split('/')[-1]} {v:.2e}"
                                                    for k, v in out.items()))
    del z, w3, w4t, w4, da4, h2, da3, planes, yt, w1, ht, w2, cases
    torch.cuda.empty_cache()
    # the gMLP block's six at the fusion shape, batch 512; every operand's rows
    # padded to 8, as the workspace holds them (F/2 = 384 and D = 128 are)
    geom = GMLP_FUSION
    R, D, F = 512 * geom["N"], geom["D"], geom["F"]
    H = F // 2
    xn, gated = rand(R, D).to(bf), (rand(R, H) * 0.3).to(bf)
    w_in, w_out = (rand(D, F) / D ** 0.5).to(bf), (rand(H, D) / H ** 0.5).to(bf)
    dout = (rand(R, D) * (torch.rand(R, D, generator=gen, device="cuda") < 0.9)).to(bf)
    dpre = rand(R, F) * 1e-3
    planes = [dpre.to(bf)]
    planes.append((dpre - planes[0].float()).to(bf))
    planes.append((dpre - planes[0].float() - planes[1].float()).to(bf))
    w_out_t = w_out.t().contiguous()
    gmlp = {"in": ([xn], 1, [w_in], 0, R, F, D, lambda: xn.double() @ w_in.double()),
            "out": ([gated], 1, [w_out], 0, R, D, H, lambda: gated.double() @ w_out.double()),
            "dgated": ([dout], 1, [w_out_t], 0, R, H, D,
                       lambda: dout.double() @ w_out.double().t()),
            "dxn": (planes, 1, [w_in], 1, R, D, F, lambda: dpre.double() @ w_in.double().t()),
            "dW_in": ([xn], 0, planes, 0, D, F, R, lambda: xn.double().t() @ dpre.double()),
            "dW_out": ([gated], 0, [dout], 0, H, D, R,
                       lambda: gated.double().t() @ dout.double())}
    tiles = {"in": 64, "out": 64, "dgated": 64}
    run_engine_cases(torch, lib, gmlp, tiles, "gmlp_fusion/B512", out)
    print("  the wgmma engine's products of bf16 K3f and K3b at the gMLP fusion shape, batch "
          "512, error / max|float64|: " + ", ".join(
              f"{k.split('/')[-1]} {v:.2e}" for k, v in out.items() if k.startswith("gmlp")))
    del xn, gated, w_in, w_out, w_out_t, dout, dpre, planes, gmlp
    torch.cuda.empty_cache()
    dyna_engine_errors(torch, lib, out, gen)


def bf16_planes(torch, v):
    """v (float32) as three bf16 planes, hi = bf16(v), mid = bf16(v - hi), lo
    = bf16(v - hi - mid): how the engine takes a float32 operand."""
    bf = torch.bfloat16
    planes = [v.to(bf)]
    planes.append((v - planes[0].float()).to(bf))
    planes.append((v - planes[0].float() - planes[1].float()).to(bf))
    return planes


def dyna_engine_errors(torch, lib, out, gen) -> None:
    """bf16 K4f's three and K4b's six engine products at the DynaMixer config's
    op, batch 512 (S = 3584 sequences, S*L = 25088 rows, S*H = 28672 units;
    C 256, H*R 16, L*R 14, L*L 49), in the layouts bf16 K4f/K4b run them,
    every operand's rows padded to 8 as the workspace holds them: compress x
    W_c^T, generate gin W_g^T, out_proj mixed W_o^T (both operands K-major);
    d_mixed g W_o and d_gin d_logit W_g (g and d_logit float32, as three bf16
    planes), dx_comp d_comp W_c (B MN-major); dW_c^T x^T d_comp (the 64-wide
    tile), dW_g d_logit^T gin, dW_o g^T mixed (both MN-major, A's planes
    for the float32 ones). Each against the float64 product of the same
    values (of the float32 operand for the split ones), relative to its
    largest magnitude: out["dyna/B512/<name>"]."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    S, L, C, H, R = 7 * 512, DYNA_OP["L"], DYNA_OP["C"], DYNA_OP["H"], DYNA_OP["R"]
    rows, units, HR, LR, LL = S * L, S * H, H * R, L * R, L * L
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    pad = lambda t: F.pad(t, (0, -t.shape[1] % 8))  # noqa: E731
    x, mixed = rand(rows, C).to(bf), rand(rows, C).to(bf)
    wc, wg, wo = (rand(HR, C) / C ** 0.5).to(bf), (rand(LL, LR) / LR ** 0.5).to(bf), \
        (rand(C, C) / C ** 0.5).to(bf)
    gin, dcomp = rand(units, LR).to(bf), (rand(rows, HR) * 1e-2).to(bf)
    g, dlog = rand(rows, C), rand(units, LL) * 1e-3
    gp, dp = bf16_planes(torch, g), [pad(t) for t in bf16_planes(torch, dlog)]
    d = lambda t: t.double()  # noqa: E731
    cases = {"compress": ([x], 1, [wc], 1, rows, HR, C, lambda: d(x) @ d(wc).t()),
             "generate": ([pad(gin)], 1, [pad(wg)], 1, units, LL, LR, lambda: d(gin) @ d(wg).t()),
             "out_proj": ([mixed], 1, [wo], 1, rows, C, C, lambda: d(mixed) @ d(wo).t()),
             "d_mixed": (gp, 1, [wo], 0, rows, C, C, lambda: d(g) @ d(wo)),
             "d_gin": (dp, 1, [pad(wg)], 0, units, LR, LL, lambda: d(dlog) @ d(wg)),
             "dx_comp": ([dcomp], 1, [wc], 0, rows, C, HR, lambda: d(dcomp) @ d(wc)),
             "dW_c^T": ([x], 0, [dcomp], 0, C, HR, rows, lambda: d(x).t() @ d(dcomp)),
             "dW_g": (dp, 0, [pad(gin)], 0, LL, LR, units, lambda: d(dlog).t() @ d(gin)),
             "dW_o": (gp, 0, [mixed], 0, C, C, rows, lambda: d(g).t() @ d(mixed))}
    run_engine_cases(torch, lib, cases, {"dW_c^T": 64}, "dyna/B512", out)
    print("  the wgmma engine's products of bf16 K4f and K4b at the DynaMixer config's op, "
          "batch 512, error / max|float64|: " + ", ".join(
              f"{k.split('/')[-1]} {v:.2e}" for k, v in out.items() if k.startswith("dyna")))
    del x, mixed, wc, wg, wo, gin, dcomp, g, dlog, gp, dp, cases
    torch.cuda.empty_cache()


def run_engine_cases(torch, lib, cases, tiles, prefix, out) -> None:
    """Each case's product on the engine alone (``m2m_wg_product``, the tile
    ``tiles`` names, else 128 wide) against its float64 reference:
    out[prefix/name] = max |error| / max |float64|."""
    import ctypes

    for name, (a, a_k, b, b_k, M, N, K, ref) in cases.items():
        got = torch.empty(M, N, device="cuda")
        code = lib.m2m_wg_product(a_k, b_k, len(a), len(b), M, N, K, tiles.get(name, 128),
                                  (ctypes.c_void_p * 3)(*[t.data_ptr() for t in a]),
                                  a[0].shape[1], (ctypes.c_void_p * 3)(*[t.data_ptr() for t in b]),
                                  b[0].shape[1], got.data_ptr(), 0,
                                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"m2m_wg_product {name}: {lib.m2m_error_string(code).decode()}")
        want = ref()
        out[f"{prefix}/{name}"] = ((got.double() - want).abs().max() / want.abs().max()).item()
        del got, want


def dyna_counters(dk):
    return {"K4f": dk.fused_dynamixer_op.launches, "K4b": dk.fused_dynamixer_op_bwd.launches}


def dyna_zero(dk):
    dk.fused_dynamixer_op.launches = dk.fused_dynamixer_op_bwd.launches = 0


def phase_dyna_serving(torch, dk, serving, np, report):
    print("[9/16] serving the DynaMixer config (K4f in every DynaMixerOp)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dyna_") as tmp:
        serving.main(["export", "-c", DYNA_CFG, "-o", tmp])
        card, cpu = serving.load_serving(tmp), serving.load_serving(tmp, device="cpu")
    rng = np.random.RandomState(4)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    # the main path: the counter zeroed just before, read just after
    dyna_zero(dk)
    answers = {n: card.predict(feats) for n, feats in requests.items()}
    launches = dk.fused_dynamixer_op.launches
    forwards = sum(-(-n // max(card.buckets)) for n in REQUESTS)
    print(f"  main-path launches: K4f {launches} over {forwards} device forwards")
    if launches != DYNA_OPS_PER_FORWARD * forwards:
        raise AssertionError(f"K4f launched {launches} times, expected "
                             f"{DYNA_OPS_PER_FORWARD} x {forwards}")
    worst, worst_rel = 0.0, 0.0
    for n, got in answers.items():
        want = cpu.predict(requests[n])  # the same artifact's plain versions on the CPU
        for g, w in [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                                   want["branch_logits"])):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"DynaMixer n={n}: bad output {g.shape} vs {w.shape}")
            err, scale = float(np.abs(g - w).max()), max(1.0, float(np.abs(w).max()))
            if not err <= SERVED_REL * scale:
                raise AssertionError(f"DynaMixer n={n}: logits differ by {err} > "
                                     f"{SERVED_REL} x {scale}")
            worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        print(f"  request of {n}: logits {got['logits'].shape}, worst |err| against the CPU "
              f"so far {worst:.3e} ({worst_rel:.2e} of max(1, max|CPU|))")
    report["dyna_served_max_abs_err"] = worst
    report["dyna_served_max_rel_err"] = worst_rel
    report["dyna_serving_launches"] = launches
    return card


def phase_dyna_training(torch, dk, serving, run, apply_overrides, load_cfg, synthetic, np,
                        report):
    print("[12/16] training the DynaMixer config (K4f / K4b in every DynaMixerOp)")
    cfg = load_cfg(DYNA_CFG)
    apply_overrides(cfg, ["model.dropout=0.0"], warn=False)
    cpu = serving._build_task(cfg, device="cpu")
    card = serving._build_task(cfg, device="cuda")
    card.network.load_state_dict(cpu.network.state_dict())
    data = synthetic(32, seed=3, learnable=True)
    c_losses, c_grads = train_step_one(torch, cpu, {k: torch.from_numpy(v)
                                                    for k, v in data.items()})
    dyna_zero(dk)
    k_losses, k_grads = train_step_one(torch, card, {k: torch.from_numpy(v).cuda()
                                                     for k, v in data.items()})
    launched = dyna_counters(dk)
    if launched != {"K4f": DYNA_OPS_PER_FORWARD, "K4b": DYNA_OPS_PER_FORWARD}:
        raise AssertionError(f"DynaMixer step 1 launched {launched}")
    names = sorted(k_grads)
    key = "DynaMixer train step 1 (card vs CPU): loss, branch losses"
    report["errors"][key] = rel_err(torch, [t.cpu() for t in k_losses], c_losses, key,
                                    rel=LOSS_REL)
    key = f"DynaMixer train step 1 (card vs CPU): {len(names)} parameter gradients"
    report["errors"][key] = rel_err(torch, [k_grads[n].cpu() for n in names],
                                    [c_grads[n] for n in names], key)
    del cpu, card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dyna_train_") as tmp:
        argv = ["-c", DYNA_CFG, "-n", "smoke_dyna", f"train.tensorboard_path={tmp}",
                f"train.epochs={DYNA_EPOCHS}", "dataset.params.synthetic=true",
                "dataset.params.synthetic_learnable=true",
                f"dataset.params.synthetic_sizes={TRAIN_SIZES}"]
        result = train_run(run, np, argv, lambda: dyna_zero(dk), lambda: dyna_counters(dk),
                           "DynaMixer", MIN_ACC)
    for name, count in result["launches"].items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the DynaMixer training path")
    report["dyna_training_run"] = result


def phase_dyna_times(torch, dk, serving, Trainer, load_cfg, synthetic, np, served, report):
    print("[15/16] DynaMixer times (CUDA events, median of 5 runs)")
    times, bounds = report["times_ms"], report["bounds_ms"]
    busy = report["dyna_device_busy_ms"] = {}
    H, R = DYNA_OP["H"], DYNA_OP["R"]
    p = dyna_params(dk, torch, seed=43, **DYNA_OP)
    for B in (32, 512):
        S, tag = 7 * B, f"B{B}"
        gen = torch.Generator().manual_seed(7)
        x = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        g = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        times[f"K4f/{tag}"] = cuda_ms(torch, lambda: dk.fused_dynamixer_op(x, p, H, R))
        times[f"K4f_plain/{tag}"] = cuda_ms(torch, lambda: dk.dynamixer_op_reference(x, p, H, R))
        times[f"K4b/{tag}"] = cuda_ms(torch, lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R))
        times[f"K4b_plain/{tag}"] = cuda_ms(
            torch, lambda: dk.dynamixer_op_bwd_reference(x, g, p, H, R))
        if B == 512:
            bd = report.setdefault("breakdown_us", {})
            bd[f"K4f/{tag}"] = kernel_breakdown(
                torch, lambda: dk.fused_dynamixer_op(x, p, H, R), f"K4f {tag}")
            bd[f"K4b/{tag}"] = kernel_breakdown(
                torch, lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R), f"K4b {tag}")
        flops, pbytes = dyna_work(S, **DYNA_OP)
        act = x.numel() * 4
        bounds[f"K4f/{tag}"] = bound(flops, pbytes + 2 * act, "f32")
        bounds[f"K4b/{tag}"] = bound(2 * flops, 2 * pbytes + 3 * act, "f32")
        tc = report.setdefault("bounds_3xtf32_ms", {})
        tc[f"K4f/{tag}"] = flops / TC_3XTF32 * 1e3
        tc[f"K4b/{tag}"] = 2 * flops / TC_3XTF32 * 1e3
        print(f"  {tag} (S={S}): K4f {times[f'K4f/{tag}']:.4f} ms (plain "
              f"{times[f'K4f_plain/{tag}']:.4f}, bound {bounds[f'K4f/{tag}'][0]:.4f}, 3xTF32 bound "
              f"{tc[f'K4f/{tag}']:.4f}); K4b "
              f"{times[f'K4b/{tag}']:.4f} ms (plain {times[f'K4b_plain/{tag}']:.4f}, bound "
              f"{bounds[f'K4b/{tag}'][0]:.4f}, 3xTF32 bound "
              f"{report['bounds_3xtf32_ms'][f'K4b/{tag}']:.4f})")
    rng = np.random.RandomState(5)
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        fwd = lambda: served.forward_device(feats)
        times[f"dyna_served/B{B}"] = cuda_ms(torch, fwd, iters=5)
        busy[f"served/B{B}"] = device_busy_ms(torch, fwd)
    print(f"  served forward: B=32 {times['dyna_served/B32']:.4f} ms, B=512 "
          f"{times['dyna_served/B512']:.4f} ms")
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dyna_steps_") as tmp:
        cfg = load_cfg(DYNA_CFG)
        task = serving._build_task(cfg, device="cuda")
        trainer = Trainer(cfg.train, name="dyna_steps", work_dir=tmp)
        trainer.setup(task)
        ctx = task.make_ctx(0, "train")
        for B in (32, 512):
            batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
            step = lambda: trainer.train_step(task, batch, ctx)
            torch.cuda.reset_peak_memory_stats()
            times[f"dyna_train_step/B{B}"] = cuda_ms(torch, step, iters=5)
            report.setdefault("dyna_train_step_peak_gib", {})[f"B{B}"] = \
                torch.cuda.max_memory_allocated() / 2**30
            busy[f"train_step/B{B}"] = device_busy_ms(torch, step)
        trainer.logger.close()
    print(f"  train step (the config: dropout 0.5, Adam): B=32 "
          f"{times['dyna_train_step/B32']:.4f} ms, B=512 {times['dyna_train_step/B512']:.4f} ms; "
          f"peak memory (GiB) {report['dyna_train_step_peak_gib']}")
    for key, ms in busy.items():
        print(f"  device busy, {key}: {ms:.4f} ms a call "
              f"({ms / times['dyna_' + key]:.1%} of its CUDA-event time)")


# ------------------------------------ the bf16 DynaMixerOp and the L geometry
L_CFG = os.path.join(REPO, "cfg", "avmnist", "avmnist_m2-mixer_L.yml")
# avmnist_m2-mixer_L.yml's three mixers: 4 image blocks of 16 tokens, 4 audio
# blocks of 64, 2 fusion blocks of 80 (16 + 64 fused); at D = 512 none of them
# fits the backward's register tiles, so every backward runs the token FF as
# products; the forward does at 64 and 80 tokens and keeps the register route
# at 16
L_GEOMS = (("image", dict(N=16, D=512, T=256, C=4096), 4),
           ("audio", dict(N=64, D=512, T=256, C=4096), 4),
           ("fusion", dict(N=80, D=512, T=256, C=4096), 2))
# The share of bf16 elements allowed to differ from the plain version at the L
# shapes. Single blocks: as at B. The stacks, at the main path's depth (4 image,
# 4 audio, 2 fusion blocks + the final LN): their flips compound over more and
# longer sums than at B, and a second correct implementation (the plain version
# with float64 sums, float64_sums) already differs from the plain version in a
# share that grows with the depth, so each stack is held to that floor, measured
# each run, + L_STACK_EXCESS. The excess sits between the readings of
# the kernel's and the float32-math control's excess over that floor, in the
# six cases (3 shapes x batch 32 / 512) at this depth (H100 80GB HBM3, 700 W,
# PERF.md §6, PR 11): K2f's output, kernel -0.008 to 0.017, control 0.361 to
# 0.583; K2b's rounded gradients, kernel -0.002 to 0.014, control 0.116 to
# 0.330.
L_BF16_SHARE = {"K1f": BF16_MISMATCH, "K1b": BF16_GRAD_SHARE["K1b"]}
L_STACK_EXCESS = 0.05
L_TRAIN_SIZES = "[2048, 512, 512]"  # 4 steps an epoch at the config's batch 512
L_FLAVORS = ("plain", "stacked", "per_block")  # plain: the config as shipped
# The L kernel artifact's served logits are held to the same artifact's plain
# versions on the CPU (JAX's kernel math) within BF16_REL x max(1, max|CPU|), as
# the DynaMixer artifact is, and not to the plain bf16 modules: on trained L
# weights the residual stream reaches |x| ~ 200 (bf16 ulp 1.0), and on rare
# samples JAX's kernel cast scheme parts from float32 faster than the plain
# modules' (ROADMAP.md §3: JAX's own _block_math departs from float32 exactly as
# the port's does on the same weights and sample), so the two bf16 paths can
# differ by more than 5e-2 of the max logit though each follows its reference.
# The distances to the plain bf16 and the float32 network are printed beside.
# bf16 K4f's output is float32 (sums of products of bf16 values, biases added in
# float32): within this share of max(1, max|plain|) of the plain bf16 version.
# A float32 sum in another order moves a rounded intermediate by one ulp now and
# then (float64 sums with the same casts sit 5.8e-4 from the float32 ones on the
# CPU at S = 1568); the float32-math control sits 3.2e-3 away and must fail.
DYNA_BF16_FWD = 1.5e-3
DYNA_ROUNDED = (False, True, False, True, False, True, False)  # dx, DynaMixerOpParams


@contextlib.contextmanager
def float64_sums(torch):
    """While open, torch.matmul sums in float64 and rounds its result to the
    operands' type: the mixer's plain versions (every product is a
    torch.matmul) then compute the same casts with sums exact to float32, a
    second correct implementation whose share of bf16 elements differing from
    the plain version is the floor a kernel's share is read against."""
    matmul = torch.matmul
    torch.matmul = lambda a, b: matmul(a.double(), b.double()).to(
        torch.promote_types(a.dtype, b.dtype))
    try:
        yield
    finally:
        torch.matmul = matmul


def dyna_bf16_fwd_check(torch, got, want, control, what, report) -> float:
    """bf16 K4f (DYNA_BF16_FWD); the float32-math control must fail it
    (``control`` None: not run, at shapes whose outputs are too small for
    the absolute part of the limit to tell the two apart). Returns the max
    absolute error."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    c_rel = None if control is None else (control - want).abs().max().item() / scale
    print(f"  {what}: max |err| {err:.3e} ({err / scale:.2e} of max(1, max|plain|), tol "
          f"{DYNA_BF16_FWD}); float32-math control "
          + ("not run" if c_rel is None else f"{c_rel:.2e}"))
    report["bf16_checks"][what] = {"max_abs_err": err, "rel_err": err / scale,
                                   "control_rel_err": c_rel}
    if not err <= DYNA_BF16_FWD * scale:
        raise AssertionError(f"{what}: max |err| {err} > {DYNA_BF16_FWD} x {scale}")
    if c_rel is not None and c_rel <= DYNA_BF16_FWD:
        raise AssertionError(f"{what}: the float32-math control passes the bf16 check")
    return err


def phase_dyna_bf16_kernels(torch, dk, report):
    print("[6/16] K4f / K4b in bf16 compute vs the plain bf16 version and its autograd "
          "(float32 parameters, rounded where _op_math casts them), every product on the "
          "wgmma engine")
    bf16 = torch.bfloat16
    cases = [(f"B{B}", dict(S=7 * B, **DYNA_OP), 41, (1, 30)) for B in (32, 512)]
    cases += [(name, dict(S=DYNA_LIFTED_S, **geom), 42, (1, 30))
              for name, geom in DYNA_LIFTED.items()]
    for case, geom, seed, scales in cases:
        S, L, C, H, R = (geom[k] for k in "SLCHR")
        p = dyna_params(dk, torch, seed=seed, L=L, C=C, H=H, R=R)
        gen = torch.Generator().manual_seed(S)
        x1 = torch.randn(S, L, C, generator=gen).cuda()
        g = torch.randn(S, L, C, generator=gen).cuda()
        for scale in scales:
            tag = f"{case}/x{scale}"
            x = scale * x1
            got, counts = tallied(torch, lambda: dk.fused_dynamixer_op(x, p, H, R,
                                                                       compute_dtype=bf16))
            check_wg_route(counts, f"K4f_bf16/{tag}", {"K4f": 1})
            # the control at the config's op, and at the lifted shapes at x30
            # (at x1 their outputs sit below 1, where max(1, .) leaves bf16 and
            # float32 math within 1.5e-3)
            control = (dk.dynamixer_op_reference(x, p, H, R)
                       if case.startswith("B") or scale == 30 else None)
            report["errors"][f"K4f_bf16/{tag}"] = dyna_bf16_fwd_check(
                torch, got, dk.dynamixer_op_reference(x, p, H, R, bf16), control,
                f"K4f_bf16/{tag}", report)
            if not torch.equal(got, dk.fused_dynamixer_op(x, p, H, R, compute_dtype=bf16)):
                raise AssertionError(f"K4f_bf16/{tag}: two runs differ")
            run = lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf16)
            (dx, grads), counts = tallied(torch, run)
            check_wg_route(counts, f"K4b_bf16/{tag}", {"K4b": 1})
            want = dk.dynamixer_op_bwd_reference(x, g, p, H, R, bf16)
            f32 = dk.dynamixer_op_bwd_reference(x, g, p, H, R)
            control = [round_bf16(torch, t) if r else t
                       for t, r in zip((f32[0], *f32[1]), DYNA_ROUNDED)]
            cpu = None
            if case == "B32":
                c = dk.dynamixer_op_bwd_reference(x.cpu(), g.cpu(), [t.cpu() for t in p], H, R,
                                                  bf16)
                cpu = (c[0], *c[1])
            report["errors"][f"K4b_bf16/{tag}"] = bf16_grad_check(
                torch, (dx, *grads), (want[0], *want[1]), control, cpu, DYNA_ROUNDED,
                BF16_GRAD_SHARE["K1b"], f"K4b_bf16/{tag}", report)
            dx2, grads2 = run()
            if not all(torch.equal(a, b) for a, b in zip((dx, *grads), (dx2, *grads2))):
                raise AssertionError(f"K4b_bf16/{tag}: two backward runs differ")


def phase_l_kernels(torch, mk, report):
    """K1f, K2f and K2b (the main path's depth + LN), K1b at the three L
    mixers' shapes, batch 32 (dropout 0.5) and 512 (dropout 0), float32
    (F32_ATOL, grad_err) and bf16 (bf16_err, bf16_grad_check, each with its
    float32-math control), against the plain versions on the card."""
    print("[4/16] K1f / K2f / K1b / K2b at the L geometry (N = 16, 64, 80; D 512, T 256, "
          "C 4096; tanh GELU) vs the plain versions, float32 and bf16")
    bf16 = torch.bfloat16
    for geom_name, geom, K in L_GEOMS:
        blocks, s, b = rand_blocks(mk, torch, K, seed=51, **geom)
        flat = mk.stack_flat_params(blocks, s, b)
        for B in (32, 512):
            rate = 0.5 if B == 32 else 0.0
            gen = torch.Generator().manual_seed(B)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for dtype, cd in (("f32", torch.float32), ("bf16", bf16)):
                tag = f"L/{geom_name}/B{B}/{dtype}"
                fwd = {"K1f": (lambda c: mk.fused_mixer_block(x, blocks[0], 7, rate, c, True),
                               lambda c: mk.mixer_block_reference(x, blocks[0], rate, c, True,
                                                                  seed=7)),
                       "K2f": (lambda c: mk.fused_mixer_stack(x, flat, 8, rate, c, True, True),
                               lambda c: mk.mixer_stack_reference(x, flat, c, True, True, rate,
                                                                  seed=8))}
                for name, (kernel, plain) in fwd.items():
                    key = f"{name}/{tag}"
                    if dtype == "f32":
                        report["errors"][key] = max_err(torch, kernel(cd), plain(cd), key)
                        continue
                    with float64_sums(torch):
                        second = plain(cd)
                    report["errors"][key] = bf16_err(
                        torch, kernel(cd), plain(cd), round_bf16(torch, plain(torch.float32)),
                        key, report, second, L_BF16_SHARE.get(name),
                        None if name in L_BF16_SHARE else L_STACK_EXCESS)
                    check_fwd_engine_route(launch_counts(torch, lambda: kernel(cd)), key,
                                           1 if name == "K1f" else K)
                bwd = {"K1b": (lambda c: mk.fused_mixer_block_bwd(x, g, blocks[0], 7, rate, c,
                                                                  True),
                               lambda c: mk.mixer_block_bwd_reference(x, g, blocks[0], rate, c,
                                                                      True, seed=7),
                               (True, *BF16_ROUNDED), (False,) * 13),
                       "K2b": (lambda c: mk.fused_mixer_stack_bwd(x, g, flat, 9, rate, c, True,
                                                                  True),
                               lambda c: mk.mixer_stack_bwd_reference(x, g, flat, rate, c, True,
                                                                      True, seed=9),
                               (True, *(BF16_ROUNDED * K), True, True),
                               (False, *(tuple(i == 5 and rate == 0.0 for i in range(12))
                                         * K), False, False))}
                for name, (kernel, plain, rounded, dead) in bwd.items():
                    key = f"{name}/{tag}"
                    got, want = kernel(cd), plain(cd)
                    got, want = (got[0], *got[1]), (want[0], *want[1])
                    if dtype == "f32":
                        report["errors"][key] = grad_err(torch, got, want, key, dead)
                        continue
                    f32 = plain(torch.float32)
                    control = [round_bf16(torch, t) if r else t
                               for t, r in zip((f32[0], *f32[1]), rounded)]
                    with float64_sums(torch):
                        second = plain(cd)
                    report["errors"][key] = bf16_grad_check(
                        torch, got, want, control, (second[0], *second[1]), rounded,
                        L_BF16_SHARE.get(name), key, report, dead=dead,
                        second_name="the plain version with float64 sums",
                        excess=None if name in L_BF16_SHARE else L_STACK_EXCESS)
                    del got, want, f32, control, second
            del x, g
            torch.cuda.empty_cache()


def l_task(serving, apply_overrides, load_cfg, flavor, extra=(), device="cuda"):
    cfg = load_cfg(L_CFG)
    apply_overrides(cfg, [*KERNEL_BLOCKS.get(flavor, []), *extra], warn=False)
    return serving._build_task(cfg, device=device), cfg


def l_counters(mk):
    return {"K1f": mk.fused_mixer_block.launches, "K2f": mk.fused_mixer_stack.launches,
            "K1b_bf16": mk.fused_mixer_block_bwd.bf16_launches,
            "K2b_bf16": mk.fused_mixer_stack_bwd.bf16_launches,
            **{f"{k}_token_ff": fn.token_ff_launches
               for k, fn in (("K1f", mk.fused_mixer_block), ("K2f", mk.fused_mixer_stack),
                             ("K1b", mk.fused_mixer_block_bwd), ("K2b", mk.fused_mixer_stack_bwd))}}


def zero_l_counters(mk):
    zero_bf16_counters(mk)
    for fn in (mk.fused_mixer_block, mk.fused_mixer_stack, mk.fused_mixer_block_bwd,
               mk.fused_mixer_stack_bwd):
        fn.token_ff_launches = 0


def phase_l_training(torch, mk, serving, run, apply_overrides, load_cfg, synthetic, np, report,
                     tmp):
    """avmnist_m2-mixer_L.yml at full width, as shipped (bf16, tanh GELU, bits
    dropout, dropout 0.5, batch 512, bf16 Adam moment): step 1 at dropout 0
    on the card against the CPU at batch 4 through both kernel block types;
    then 2-epoch runs of the config as shipped (plain modules) and with each
    kernel block type; then the plain run's weights served through
    ``serving export --pallas``. Returns the kernel artifact and the plain
    task (for the times)."""
    print("[10/16] training the L config (bf16, 16 + 64 tokens, 80 fused, D 512, C 4096, "
          "batch 512) through PallasStacked* / Pallas*: step 1 on the card against the CPU, "
          "then 2-epoch runs")
    batch = synthetic(4, seed=3, learnable=True)
    for flavor in ("stacked", "per_block"):
        task, _ = l_task(serving, apply_overrides, load_cfg, flavor, ["model.dropout=0.0"])
        cpu, _ = l_task(serving, apply_overrides, load_cfg, flavor, ["model.dropout=0.0"],
                        device="cpu")
        cpu.network.load_state_dict(task.network.state_dict())
        zero_l_counters(mk)
        g_losses, g_grads = train_step_one(torch, task, {k: torch.from_numpy(v).cuda()
                                                         for k, v in batch.items()})
        launched = l_counters(mk)
        c_losses, c_grads = train_step_one(torch, cpu, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
        names = ("K2f", "K2b") if flavor == "stacked" else ("K1f", "K1b")
        if not all(launched[f"{n}_token_ff"] > 0 for n in names):
            raise AssertionError(f"L step 1 ({flavor}) ran no token-pipeline kernel: {launched}")
        key = f"L step 1/{flavor}: loss, branch losses"
        report["errors"][key] = rel_err(torch, torch.stack(g_losses).cpu(),
                                        torch.stack(c_losses), key, BF16_REL)
        grads = sorted(g_grads)
        dead = [n for n in grads if n.endswith(TOKEN_OUT_BIAS)]
        live = [n for n in grads if n not in dead]
        key = f"L step 1/{flavor}: {len(grads)} parameter gradients"
        report["errors"][key] = rel_err(torch, [g_grads[n].cpu() for n in live],
                                        [c_grads[n] for n in live], key, BF16_REL)
        scale = max(c_grads[n].abs().max().item() for n in grads)
        noise = max(max(g_grads[n].abs().max().item(), c_grads[n].abs().max().item())
                    for n in dead)
        print(f"  {len(dead)} exactly-zero gradients (token FF output biases): at most "
              f"{noise:.3e} on either side (tol {BF16_REL} x {scale:.3e})")
        if not dead or not noise <= BF16_REL * scale:
            raise AssertionError(f"{key}: exactly-zero gradients {dead} reach {noise}")
        del task, cpu, g_grads, c_grads
        torch.cuda.empty_cache()

    runs = report["l_runs"] = {}
    for flavor in L_FLAVORS:
        argv = ["-c", L_CFG, "-n", f"l_{flavor}", f"train.tensorboard_path={tmp}",
                "train.epochs=2", "dataset.params.synthetic=true",
                "dataset.params.synthetic_learnable=true",
                f"dataset.params.synthetic_sizes={L_TRAIN_SIZES}", *KERNEL_BLOCKS.get(flavor, [])]
        runs[flavor] = train_run(run, np, argv, lambda: zero_l_counters(mk),
                                 lambda: l_counters(mk), f"L {flavor}", 0.0)
        got = runs[flavor]["launches"]
        if flavor == "plain" and any(got.values()):
            raise AssertionError(f"the plain L run launched mixer kernels: {got}")
        for name in {"stacked": ("K2f", "K2b_bf16", "K2f_token_ff", "K2b_token_ff"),
                     "per_block": ("K1f", "K1b_bf16", "K1f_token_ff", "K1b_token_ff")}.get(
                flavor, ()):
            if got[name] <= 0:
                raise AssertionError(f"{name} was never launched on the L training path")
        torch.cuda.empty_cache()

    print("[10/16] serving the trained L weights (the plain run's) through serving export "
          "--pallas (bf16 K2f stacks, the token FF as products) against the same artifact on "
          "the CPU")
    log_root = os.path.join(tmp, "l_plain")
    weights = os.path.join(log_root, sorted(os.listdir(log_root))[-1], "checkpoints",
                           "best.npz")
    art = os.path.join(tmp, "l_art")
    serving.main(["export", "-c", L_CFG, "-p", weights, "-o", art, "--pallas"])
    model, on_cpu = serving.load_serving(art), serving.load_serving(art, device="cpu")
    kinds = {type(m).__name__ for m in model.task.network.modules()}
    if not {"PallasStackedMLPMixer", "PallasStackedFusionMixer"} <= kinds:
        raise AssertionError(f"the L kernel artifact holds {sorted(kinds)}")
    plain, _ = l_task(serving, apply_overrides, load_cfg, "plain")
    plain.network.load_state_dict(serving.load_npz(weights, plain.network))
    # the same weights in float32: how far each bf16 path sits from it
    f32, _ = l_task(serving, apply_overrides, load_cfg, "plain", ["model.precision=float32"])
    f32.network.load_state_dict(serving.load_npz(weights, f32.network))
    rng = np.random.RandomState(2)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    zero_l_counters(mk)
    answers = {n: model.predict(f) for n, f in requests.items()}
    launched = l_counters(mk)
    print(f"  main-path launches: K2f {launched['K2f']} ({launched['K2f_token_ff']} with the "
          "token FF as products)")
    if launched["K2f_token_ff"] <= 0:
        raise AssertionError("K2f's token pipeline was never launched serving L")
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))
    worst, gaps = 0.0, {"kernel to plain bf16": 0.0, "kernel to float32": 0.0,
                        "plain bf16 to float32": 0.0}
    for n, got in answers.items():
        feats = {f: torch.from_numpy(v).cuda() for f, v in requests[n].items()}
        want = on_cpu.predict(requests[n])
        bf, ref = serving.serve_fn(plain)(feats), serving.serve_fn(f32)(feats)
        for gl, wl, bl, rl in [(got["logits"], want["logits"], bf["logits"], ref["logits"])] + \
                list(zip(got["branch_logits"], want["branch_logits"], bf["branch_logits"],
                         ref["branch_logits"])):
            bl, rl = bl.float().cpu().numpy(), rl.float().cpu().numpy()
            if gl.shape != wl.shape or not np.isfinite(gl).all():
                raise AssertionError(f"L request of {n}: bad output {gl.shape}")
            worst = max(worst, rel(gl, wl))
            for key, (a, b) in {"kernel to plain bf16": (gl, bl), "kernel to float32": (gl, rl),
                                "plain bf16 to float32": (bl, rl)}.items():
                gaps[key] = max(gaps[key], rel(a, b))
        print(f"  request of {n}: worst |err| against the CPU / max(1, max|CPU|) so far "
              f"{worst:.3e}")
    print(f"  requests of {list(REQUESTS)}: worst |err| / max(1, max|CPU|) {worst:.3e} (tol "
          f"{BF16_REL}); worst / max(1, max|reference|): " +
          ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    if not worst <= BF16_REL:
        raise AssertionError(f"L served logits differ from the same artifact on the CPU by {worst}")
    report["l_served_rel_err"] = worst
    report["l_served_gaps"] = gaps
    report["l_serving_launches"] = launched
    return model, plain


def dyna_bf16_counters(dk):
    return {"K4f_bf16": dk.fused_dynamixer_op.bf16_launches,
            "K4b_bf16": dk.fused_dynamixer_op_bwd.bf16_launches}


def dyna_bf16_zero(dk):
    dk.fused_dynamixer_op.bf16_launches = dk.fused_dynamixer_op_bwd.bf16_launches = 0


def phase_dyna_bf16(torch, dk, serving, run, np, report):
    """avmnist_3loss_dyna.yml at model.precision=bf16: a run.main of DYNA_EPOCHS
    epochs (bf16 K4f/K4b in every DynaMixerOp), then its best weights exported
    and served on the card (bf16 K4f) against the same artifact on the CPU."""
    print("[12/16] the DynaMixer config in bf16 (model.precision=bf16): training, then "
          "serving against the CPU")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dyna_bf16_") as tmp:
        argv = ["-c", DYNA_CFG, "-n", "smoke_dyna_bf16", f"train.tensorboard_path={tmp}",
                f"train.epochs={DYNA_EPOCHS}", "dataset.params.synthetic=true",
                "dataset.params.synthetic_learnable=true",
                f"dataset.params.synthetic_sizes={TRAIN_SIZES}", "model.precision=bf16"]
        result, counts = tallied(torch, lambda: train_run(
            run, np, argv, lambda: dyna_bf16_zero(dk), lambda: dyna_bf16_counters(dk),
            "DynaMixer bf16", 0.0))
        for name, count in result["launches"].items():
            if count <= 0:
                raise AssertionError(f"{name} was never launched on the bf16 DynaMixer path")
        check_wg_route(counts, "the bf16 DynaMixer training run",
                                {"K4f": result["launches"]["K4f_bf16"],
                                 "K4b": result["launches"]["K4b_bf16"]})
        report["dyna_bf16_training_run"] = result
        log_root = os.path.join(tmp, "smoke_dyna_bf16")
        weights = os.path.join(log_root, sorted(os.listdir(log_root))[-1], "checkpoints",
                               "best.npz")
        art = os.path.join(tmp, "art")
        serving.main(["export", "-c", DYNA_CFG, "-p", weights, "-o", art,
                      "model.precision=bf16"])
        card, cpu = serving.load_serving(art), serving.load_serving(art, device="cpu")
    rng = np.random.RandomState(6)
    requests = {n: {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
                    "audio": rng.rand(n, 1, 112, 112).astype(np.float32)} for n in REQUESTS}
    dyna_bf16_zero(dk)
    answers, counts = tallied(torch, lambda: {n: card.predict(feats)
                                              for n, feats in requests.items()})
    launches = dk.fused_dynamixer_op.bf16_launches
    check_wg_route(counts, "the bf16 DynaMixer serving run", {"K4f": launches})
    forwards = sum(-(-n // max(card.buckets)) for n in REQUESTS)
    print(f"  main-path launches: bf16 K4f {launches} over {forwards} device forwards")
    if launches != DYNA_OPS_PER_FORWARD * forwards:
        raise AssertionError(f"bf16 K4f launched {launches} times, expected "
                             f"{DYNA_OPS_PER_FORWARD} x {forwards}")
    worst = 0.0
    for n, got in answers.items():
        want = cpu.predict(requests[n])
        for gl, wl in [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                                   want["branch_logits"])):
            if gl.shape != wl.shape or not np.isfinite(gl).all():
                raise AssertionError(f"bf16 DynaMixer n={n}: bad output {gl.shape}")
            worst = max(worst, float(np.abs(gl - wl).max()) / max(1.0, float(np.abs(wl).max())))
    print(f"  requests of {list(REQUESTS)}: worst |err| / max(1, max|CPU|) {worst:.3e} "
          f"(tol {BF16_REL})")
    if not worst <= BF16_REL:
        raise AssertionError(f"bf16 DynaMixer served logits differ from the CPU by {worst}")
    report["dyna_bf16_served_rel_err"] = worst
    report["dyna_bf16_serving_launches"] = launches
    return card


def phase_new_route_times(torch, mk, dk, serving, Trainer, apply_overrides, load_cfg, synthetic,
                          np, report, l_served, dyna_bf16_served):
    """The routes this slice added, CUDA events (median of 5 runs): K1f, K2f, K1b
    and K2b at the L shapes in float32 and bf16 (5 calls a run) with their plain
    versions and bounds; bf16 K4f / K4b; the L served forward and train step;
    the bf16 DynaMixer served forward."""
    print("[15/16] times of the new routes (CUDA events, median of 5 runs)")
    times, bounds = report["times_ms"], report["bounds_ms"]
    tc = report.setdefault("bounds_tc_ms", {})
    bf16 = torch.bfloat16
    for geom_name, geom, K in L_GEOMS:
        blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=53, **geom)
        flat = mk.stack_flat_params(blocks, ln_s, ln_b)
        for B in (32, 512):
            gen = torch.Generator().manual_seed(5)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            for dtype, cd in (("f32", torch.float32), ("bf16", bf16)):
                tag = f"L/{geom_name}/B{B}/{dtype}"
                with torch.no_grad():
                    _, saved = mk._stack_forward(x, flat, 1, 0.5, cd, True, False, save=True)
                calls = {
                    "K1f": lambda: mk.fused_mixer_block(x, blocks[0], compute_dtype=cd),
                    "K1f_plain": lambda: mk.mixer_block_reference(x, blocks[0], compute_dtype=cd),
                    "K2f": lambda: mk.fused_mixer_stack(x, flat, compute_dtype=cd),
                    "K2f_plain": lambda: mk.mixer_stack_reference(x, flat, cd),
                    "K1b": lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 1, 0.5, cd),
                    "K1b_plain": lambda: mk.mixer_block_bwd_reference(x, g, blocks[0], 0.5, cd,
                                                                      seed=1),
                    "K2b": lambda: mk.fused_mixer_stack_bwd(x, g, flat, 1, 0.5, cd, saved=saved),
                    "K2b_plain": lambda: mk.mixer_stack_bwd_reference(x, g, flat, 0.5, cd,
                                                                      seed=1)}
                for name, fn in calls.items():
                    times[f"{name}/{tag}"] = cuda_ms(torch, fn, iters=5)
                ffl, pbytes = block_work(B, **geom, wbytes=2 if dtype == "bf16" else 4)
                act = 2 * B * geom["N"] * geom["D"] * 4
                bfl, bbytes = bwd_work(B, **geom)
                peak = "bf16" if dtype == "bf16" else "f32"
                bounds[f"K1f/{tag}"] = bound(ffl, pbytes + act, peak)
                bounds[f"K2f/{tag}"] = bound(K * ffl, K * pbytes + 8 * geom["D"] + act, peak)
                bounds[f"K1b/{tag}"] = bound(bfl, bbytes, peak)
                bounds[f"K2b/{tag}"] = bound(K * bfl, K * (bbytes - 1.5 * act) + 1.5 * act, peak)
                # the tensor-core rate of the products as the kernels run them: 3xTF32 in
                # float32; in bf16 the designs' bounds (the forward's four products on
                # the wgmma engine, the backward's nine passes and the token products)
                if dtype == "f32":
                    tc[f"K1f/{tag}"] = ffl / TC_3XTF32 * 1e3
                else:
                    tc[f"K1f/{tag}"] = bf16_fwd_design_ms(
                        B, geom["N"], geom["D"], geom["T"], geom["C"],
                        bool(mk._token_ff("fwd", x, flat, torch.bfloat16)))
                tc[f"K2f/{tag}"] = K * tc[f"K1f/{tag}"]
                tc[f"K1b/{tag}"] = bfl / TC_3XTF32 * 1e3 if dtype == "f32" else \
                    bf16_bwd_design_ms(B, geom["N"], geom["D"], geom["T"], geom["C"], True)
                tc[f"K2b/{tag}"] = K * tc[f"K1b/{tag}"]
                print(f"  {tag}: " + "; ".join(
                    f"{n} {times[f'{n}/{tag}']:.4f} ms (plain {times[f'{n}_plain/{tag}']:.4f}, "
                    f"bound {bounds[f'{n}/{tag}'][0]:.4f}, tensor-core bound "
                    f"{tc[f'{n}/{tag}']:.4f})" for n in ("K1f", "K2f", "K1b", "K2b")))
                if geom_name == "fusion" and B == 512:
                    bd = report.setdefault("breakdown_us", {})
                    bd[f"K1f/{tag}"] = kernel_breakdown(torch, calls["K1f"], f"K1f {tag}")
                    bd[f"K1b/{tag}"] = kernel_breakdown(torch, calls["K1b"], f"K1b {tag}")
                if dtype == "bf16" and B == 512:
                    check_engine_route(launch_counts(torch, calls["K2b"]), f"K2b {tag}", K)
                    prods = channel_products(launch_sequence(torch, calls["K1b"]))
                    report.setdefault("channel_products_us", {})[f"K1b/{tag}"] = prods
                    print(f"  K1b {tag}: the channel products {sum(us for _, us in prods):.1f} "
                          "us (" + ", ".join(f"{us:.1f}" for _, us in prods) + ")")
                    check_fwd_engine_route(launch_counts(torch, calls["K1f"]), f"K1f {tag}")
                    seq = launch_sequence(torch, calls["K1f"])
                    report.setdefault("launches_us", {})[f"K1f/{tag}"] = seq
                    prods = fwd_channel_products(kernel_breakdown(torch, calls["K1f"], None))
                    report["channel_products_us"][f"K1f/{tag}"] = prods
                    print(f"  K1f {tag}: " + ", ".join(f"{n.split('<')[0]} {us:.1f}"
                                                       for n, us in seq) + " us; the channel "
                          f"products {sum(us for _, us in prods):.1f} us")
                del saved, calls
            del x, g
            torch.cuda.empty_cache()
    H, R = DYNA_OP["H"], DYNA_OP["R"]
    p = dyna_params(dk, torch, seed=43, **DYNA_OP)
    for B in (32, 512):
        S, tag = 7 * B, f"B{B}"
        gen = torch.Generator().manual_seed(7)
        x = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        g = torch.randn(S, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        times[f"K4f_bf16/{tag}"] = cuda_ms(torch, lambda: dk.fused_dynamixer_op(
            x, p, H, R, compute_dtype=bf16))
        times[f"K4f_bf16_plain/{tag}"] = cuda_ms(torch, lambda: dk.dynamixer_op_reference(
            x, p, H, R, bf16))
        times[f"K4b_bf16/{tag}"] = cuda_ms(torch, lambda: dk.fused_dynamixer_op_bwd(
            x, g, p, H, R, compute_dtype=bf16))
        times[f"K4b_bf16_plain/{tag}"] = cuda_ms(torch, lambda: dk.dynamixer_op_bwd_reference(
            x, g, p, H, R, bf16))
        flops, pbytes = dyna_work(S, **DYNA_OP)
        act = x.numel() * 4
        bounds[f"K4f_bf16/{tag}"] = bound(flops, pbytes + 2 * act, "bf16")
        bounds[f"K4b_bf16/{tag}"] = bound(2 * flops, 2 * pbytes + 3 * act, "bf16")
        design = report.setdefault("bounds_design_ms", {})
        design[f"K4f_bf16/{tag}"], design[f"K4b_bf16/{tag}"] = bf16_dyna_design_ms(S, **DYNA_OP)
        print(f"  {tag} (S={S}): K4f bf16 {times[f'K4f_bf16/{tag}']:.4f} ms (plain "
              f"{times[f'K4f_bf16_plain/{tag}']:.4f}, bound {bounds[f'K4f_bf16/{tag}'][0]:.4f}, "
              f"bf16_dyna_design_ms {design[f'K4f_bf16/{tag}']:.4f}); "
              f"K4b bf16 {times[f'K4b_bf16/{tag}']:.4f} ms (plain "
              f"{times[f'K4b_bf16_plain/{tag}']:.4f}, bound {bounds[f'K4b_bf16/{tag}'][0]:.4f}, "
              f"bf16_dyna_design_ms {design[f'K4b_bf16/{tag}']:.4f})")
        if B == 512:
            bd = report.setdefault("breakdown_us", {})
            bd[f"K4f_bf16/{tag}"] = kernel_breakdown(torch, lambda: dk.fused_dynamixer_op(
                x, p, H, R, compute_dtype=bf16), f"K4f bf16 {tag}")
            bd[f"K4b_bf16/{tag}"] = kernel_breakdown(torch, lambda: dk.fused_dynamixer_op_bwd(
                x, g, p, H, R, compute_dtype=bf16), f"K4b bf16 {tag}")
    rng = np.random.RandomState(5)
    model, plain = l_served
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        times[f"l_served/stacked/B{B}"] = cuda_ms(torch, lambda: model.forward_device(feats),
                                                  iters=5)
        times[f"l_served/plain/B{B}"] = cuda_ms(torch, lambda: serving.serve_fn(plain)(feats),
                                                iters=5)
        times[f"dyna_bf16_served/B{B}"] = cuda_ms(
            torch, lambda: dyna_bf16_served.forward_device(feats), iters=5)
    print("  L served forward (bf16): " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items() if k.startswith("l_served/")))
    print(f"  bf16 DynaMixer served forward: B=32 {times['dyna_bf16_served/B32']:.4f} ms, B=512 "
          f"{times['dyna_bf16_served/B512']:.4f} ms")
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_l_steps_") as tmp:
        for flavor in L_FLAVORS:
            task, cfg = l_task(serving, apply_overrides, load_cfg, flavor)
            trainer = Trainer(cfg.train, name=f"l_steps_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            for B in (32, 512):
                batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                torch.cuda.reset_peak_memory_stats()
                times[f"l_train_step/{flavor}/B{B}"] = cuda_ms(
                    torch, lambda: trainer.train_step(task, batch, ctx), iters=5)
                report.setdefault("l_train_step_peak_gib", {})[f"{flavor}/B{B}"] = \
                    torch.cuda.max_memory_allocated() / 2**30
            trainer.logger.close()
            del task, trainer
            torch.cuda.empty_cache()
    print("  L train step (bf16, dropout 0.5, bf16-moment Adam): " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
        if k.startswith("l_train_step/")))


# ------------------------------------- MIMIC and the gMLP's large-N route
MIMIC_CFG = os.path.join(REPO, "cfg", "mimic", "mimic_m2-mixer_H.yml")
# the H config's fusion mixer: the static token ahead of the 24 time tokens
MIMIC_FUSION = dict(N=25, D=64, T=8, C=64)
MIMIC_KERNEL_BLOCKS = {"stacked": ["model.modalities.multimodal.block_type="
                                   "PallasStackedFusionMixer"],
                       "per_block": ["model.modalities.multimodal.block_type=PallasFusionMixer"]}
# bench.py's levers for the MIMIC H key (bench.py:223-241)
MIMIC_BF16 = ["model.precision=bf16", "model.approximate_gelu=true", "model.bits_dropout=true",
              "train.optimizer.moment_dtype=bf16"]
# test accuracy after 2 epochs of the gen_mimic surrogate (2000 stays, seed
# 0; 1600 train, 200 val and 200 test): twice chance (6 classes); the plain
# float32 run of the same length reached 0.63 on the CPU (PERF.md)
MIMIC_MIN_ACC = 2 / 6
MIMIC_BATCHES = (128, 512)
# the large-N route: the gMLP config's widths above 128 tokens (129: ragged
# against every tile; 196: the audio gMLP at patch 8), and 128, the largest
# token count of the shared-memory SGU
GMLP_LARGE_N = (129, 196)
GMLP_LARGE = dict(D=128, F=768)
# a call's launches of the large-N route: one gmlp_vt_kernel; the products
# (float32 on tc_gemm, bf16 on the wgmma engine): K3f three, K3b eight
LARGE_N_PRODUCTS = {"K3f": 3, "K3b": 8}


def check_large_n_route(counts, what: str, kernel: str, bf16: bool, large: bool) -> None:
    """One K3f/K3b call (``counts``: its tallies) took the large-N route
    (``large``: one gmlp_vt_kernel, LARGE_N_PRODUCTS products of the dtype's
    engine, none of the other) or the shared-memory SGU (no gmlp_vt_kernel,
    the products of WG_LAUNCHES)."""
    engine, other = (("wg_gemm_kernel", "tc_gemm_kernel") if bf16 else
                     ("tc_gemm_kernel", "wg_gemm_kernel"))
    want = (1, LARGE_N_PRODUCTS[kernel], 0) if large else (0, WG_LAUNCHES[kernel], 0)
    got = (counts["gmlp_vt_kernel"], counts[engine], counts[other])
    if got != want:
        raise AssertionError(f"{what}: (gmlp_vt_kernel, {engine}, {other}) launches {got}, "
                             f"want {want}")
    print(f"  {what}: {'large-N route' if large else 'shared-memory SGU'} by the tallies "
          f"({got[0]} gmlp_vt_kernel, {got[1]} {engine})")


def phase_gmlp_large_n(torch, gk, report):
    """K3f / K3b above 128 tokens (GMLP_LARGE_N, the config's widths, batch
    32, dropout 0.1) against the plain version and its autograd: float32
    (rel_err) and bf16 (bf16_err, bf16_grad_check with their float32-math
    controls); the launch tallies show the large-N route above 128 tokens
    and the shared-memory SGU at 128; two backward runs bit-identical. Then
    F = 4096 at 196 tokens the same way."""
    print("[5/16] K3f / K3b above 128 tokens (the large-N route), float32 and bf16")
    cases = [(N, GMLP_LARGE) for N in (128, *GMLP_LARGE_N)] + [(196, dict(D=128, F=4096))]
    for N, width in cases:
        p = gmlp_params(gk, torch, N=N, seed=39, **width)
        gen = torch.Generator().manual_seed(N)
        x = torch.randn(32, N, width["D"], generator=gen).cuda()
        g = torch.randn(32, N, width["D"], generator=gen).cuda()
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            key = f"N{N}/F{width['F']}/B32/{dtype}"
            bf16 = dtype == "bf16"
            got, counts = tallied(torch, lambda: gk.fused_gmlp_block(
                x, p, seed=9, dropout_rate=0.1, compute_dtype=cd))
            check_large_n_route(counts, f"K3f/{key}", "K3f", bf16, N > 128)
            run = lambda: gk.fused_gmlp_block_bwd(x, g, p, seed=9, dropout_rate=0.1,
                                                  compute_dtype=cd)
            (dx, grads), counts = tallied(torch, run)
            check_large_n_route(counts, f"K3b/{key}", "K3b", bf16, N > 128)
            want = gk.gmlp_block_reference(x, p, 0.1, seed=9, compute_dtype=cd)
            wdx, wgrads = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=9, compute_dtype=cd)
            if not bf16:
                report["errors"][f"K3f/{key}"] = rel_err(torch, [got], [want], f"K3f/{key}")
                report["errors"][f"K3b/{key}"] = rel_err(torch, (dx, *grads), (wdx, *wgrads),
                                                         f"K3b/{key}")
            else:
                control = round_bf16(torch, gk.gmlp_block_reference(x, p, 0.1, seed=9))
                report["errors"][f"K3f/{key}"] = bf16_err(torch, got, want, control,
                                                          f"K3f/{key}", report)
                fdx, fgrads = gk.gmlp_block_bwd_reference(x, g, p, 0.1, seed=9)
                control = [round_bf16(torch, t) if r else t
                           for t, r in zip((fdx, *fgrads), GMLP_ROUNDED)]
                report["errors"][f"K3b/{key}"] = bf16_grad_check(
                    torch, (dx, *grads), (wdx, *wgrads), control, None, GMLP_ROUNDED,
                    BF16_GRAD_SHARE["K1b"], f"K3b/{key}", report)
            dx2, grads2 = run()
            if not all(torch.equal(u, v) for u, v in zip((dx, *grads), (dx2, *grads2))):
                raise AssertionError(f"K3b/{key}: two backward runs differ")
        del p, x, g


def phase_mimic_kernels(torch, mk, report):
    """K1f, K2f (the shipped one block + LN), K1b and K2b at the MIMIC H
    fusion mixer's shape (MIMIC_FUSION; the 8-wide token FF on the register
    route), batch 128 and 512, dropout 0.3 (the config's): float32 with erf
    (max_err, grad_err) and bf16 with tanh, bench.py's levers (bf16_err,
    bf16_grad_check with their float32-math controls; each call's products
    on the wgmma engine by the tallies); two backward runs bit-identical."""
    print("[4/16] K1f / K2f / K1b / K2b at the MIMIC H fusion shape (N 25, D 64, T 8, C 64), "
          "float32 and bf16")
    blocks, s, b = rand_blocks(mk, torch, 1, seed=71, **MIMIC_FUSION)
    flat = mk.stack_flat_params(blocks, s, b)
    for B in MIMIC_BATCHES:
        gen = torch.Generator().manual_seed(B + 25)
        x = torch.randn(B, MIMIC_FUSION["N"], MIMIC_FUSION["D"], generator=gen).cuda()
        g = torch.randn(B, MIMIC_FUSION["N"], MIMIC_FUSION["D"], generator=gen).cuda()
        for dtype, cd, approx in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
            tag = f"mimic/B{B}/{dtype}"
            fwd = {"K1f": (lambda: mk.fused_mixer_block(x, blocks[0], 3, 0.3, cd, approx),
                           lambda c: mk.mixer_block_reference(x, blocks[0], 0.3, c, approx,
                                                              seed=3)),
                   "K2f": (lambda: mk.fused_mixer_stack(x, flat, 4, 0.3, cd,
                                                        approximate_gelu=approx),
                           lambda c: mk.mixer_stack_reference(x, flat, c, approximate_gelu=approx,
                                                              dropout_rate=0.3, seed=4))}
            for kernel, (run, plain) in fwd.items():
                key = f"{kernel}/{tag}"
                got, counts = tallied(torch, run)
                if dtype == "f32":
                    report["errors"][key] = max_err(torch, got, plain(cd), key)
                else:
                    check_fwd_engine_route(counts, key)
                    report["errors"][key] = bf16_err(torch, got, plain(cd),
                                                     round_bf16(torch, plain(torch.float32)), key,
                                                     report)
                if not torch.equal(got, run()):
                    raise AssertionError(f"{key}: two runs differ")
            bwd = {"K1b": (lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 3, 0.3, cd, approx),
                           lambda c: mk.mixer_block_bwd_reference(x, g, blocks[0], 0.3, c, approx,
                                                                  seed=3),
                           (True, *BF16_ROUNDED)),
                   "K2b": (lambda: mk.fused_mixer_stack_bwd(x, g, flat, 4, 0.3, cd,
                                                            approximate_gelu=approx),
                           lambda c: mk.mixer_stack_bwd_reference(x, g, flat, 0.3, c,
                                                                  approximate_gelu=approx,
                                                                  seed=4),
                           (True, *BF16_ROUNDED, True, True))}
            for kernel, (run, plain, rounded) in bwd.items():
                key = f"{kernel}/{tag}"
                (dx, grads), counts = tallied(torch, run)
                want = plain(cd)
                if dtype == "f32":
                    report["errors"][key] = grad_err(torch, (dx, *grads), (want[0], *want[1]),
                                                     key)
                else:
                    # K2b without its saved block inputs recomputes the forward
                    # first: that call's two channel products, then the backward's three
                    check_engine_route({**counts, "wg_gemm_kernel": counts["wg_gemm_kernel"] -
                                        (2 if kernel == "K2b" else 0)}, key)
                    f32 = plain(torch.float32)
                    control = [round_bf16(torch, t) if r else t
                               for t, r in zip((f32[0], *f32[1]), rounded)]
                    report["errors"][key] = bf16_grad_check(
                        torch, (dx, *grads), (want[0], *want[1]), control, None, rounded,
                        BF16_GRAD_SHARE["K1b"], key, report)
                dx2, grads2 = run()
                if not all(torch.equal(u, v) for u, v in zip((dx, *grads), (dx2, *grads2))):
                    raise AssertionError(f"{key}: two backward runs differ")


def mimic_counters(mk):
    return {**counters(mk), "K1b_bf16": mk.fused_mixer_block_bwd.bf16_launches,
            "K2b_bf16": mk.fused_mixer_stack_bwd.bf16_launches}


def mimic_args(tmp, data, name, flavor, bf16):
    return ["-c", MIMIC_CFG, "-n", name, f"train.tensorboard_path={tmp}", "train.epochs=2",
            f"dataset.params.data_dir={data}", "dataset.params.num_workers=0",
            *MIMIC_KERNEL_BLOCKS.get(flavor, []), *(MIMIC_BF16 if bf16 else [])]


def mimic_task(serving, apply_overrides, load_cfg, flavor, bf16, extra=(), device="cuda"):
    cfg = load_cfg(MIMIC_CFG)
    apply_overrides(cfg, [*MIMIC_KERNEL_BLOCKS.get(flavor, []), *(MIMIC_BF16 if bf16 else []),
                          *extra], warn=False)
    return serving._build_task(cfg, device=device), cfg


def phase_mimic(torch, mk, serving, run, Trainer, apply_overrides, load_cfg, np, report, tmp):
    """The MIMIC H config (cfg/mimic/mimic_m2-mixer_H.yml) on the card at full
    width: 2-epoch ``run.main`` runs on a ``gen_mimic`` surrogate pickle
    (``im.pk``, 2000 stays) with the plain modules and the fusion mixer on
    each kernel block type, in float32 as shipped and in bf16 with bench.py's
    levers: losses finite and falling, val and test accuracy at least
    MIMIC_MIN_ACC, K2f/K2b or K1f/K1b launched (counters zeroed just before,
    read just after), no mixer kernel in the plain runs (the time mixer,
    ``MLPMixerNoPatching``, stays plain as in JAX). Then ``serving export
    --pallas`` of each plain run's best weights (K2f) against its plain
    artifact: requests of 1-600 samples, float32 within SERVED_ATOL of the
    plain forward on the card, bf16 within BF16_REL x max(1, max|CPU|) of
    the same artifact on the CPU. Then one accumulated update
    (``train.grad_accum_steps=4``, micro-batch 32, dropout 0, the stacked
    kernel blocks) on the card against the same update on the CPU: the four
    micro-batch losses within LOSS_REL, the averaged gradients within
    GRAD_REL x max(1, max|CPU|), one optimizer update."""
    from m2mixer_tpu_torch.datasets.surrogate import gen_mimic

    print("[10/16] the MIMIC H config: 2-epoch runs on a surrogate im.pk (plain modules and "
          "the fusion mixer's kernel blocks; float32 and bf16), export --pallas, one "
          "accumulated update")
    data = os.path.join(tmp, "data")
    with contextlib.redirect_stdout(io.StringIO()):
        gen_mimic(data, n=2000, seed=0)
    runs = report["mimic_runs"] = {}
    for bf16 in (False, True):
        for flavor in ("plain", "stacked", "per_block"):
            name = f"mimic_{flavor}{'_bf16' if bf16 else ''}"
            runs[name] = train_run(run, np, mimic_args(tmp, data, name, flavor, bf16),
                                   lambda: zero_bf16_counters(mk), lambda: mimic_counters(mk),
                                   f"MIMIC H {flavor} {'bf16' if bf16 else 'float32'}",
                                   MIMIC_MIN_ACC)
            got = runs[name]["launches"]
            if flavor == "plain" and any(got.values()):
                raise AssertionError(f"the plain MIMIC run launched mixer kernels: {got}")
            need = {"stacked": ("K2f", "K2b"), "per_block": ("K1f", "K1b")}.get(flavor, ())
            need += tuple(f"{k}_bf16" for k in need if k.endswith("b") and bf16)
            for k in need:
                if got[k] <= 0:
                    raise AssertionError(f"{k} was never launched on the MIMIC training path")
    report["mimic_launches"] = {
        f"{k}{sfx}": runs[f"mimic_{fl}{sfx}"]["launches"][k]
        for sfx in ("", "_bf16") for k, fl in (("K1f", "per_block"), ("K1b", "per_block"),
                                               ("K2f", "stacked"), ("K2b", "stacked"))}
    rng = np.random.RandomState(5)
    requests = {n: {"static": rng.randn(n, 5).astype(np.float32),
                    "time": rng.randn(n, 24, 12).astype(np.float32)} for n in REQUESTS}
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        log_root = os.path.join(tmp, f"mimic_plain{sfx}")
        best = os.path.join(log_root, sorted(os.listdir(log_root))[-1], "checkpoints", "best.npz")
        plain_dir, kernel_dir = os.path.join(tmp, f"plain{sfx}"), os.path.join(tmp, f"kernel{sfx}")
        over = MIMIC_BF16 if bf16 else []
        with contextlib.redirect_stdout(io.StringIO()):
            serving.main(["export", "-c", MIMIC_CFG, "-p", best, "-o", plain_dir, *over])
            serving.main(["export", "-c", MIMIC_CFG, "-p", best, "-o", kernel_dir, "--pallas",
                          *over])
        plain, kernel = serving.load_serving(plain_dir), serving.load_serving(kernel_dir)
        ref = serving.load_serving(kernel_dir, device="cpu") if bf16 else plain
        zero_counters(mk)
        answers = {n: kernel.predict(f) for n, f in requests.items()}
        launches = counters(mk)["K2f"]
        if launches <= 0 or kernel.meta["block_flavor"] != "kernel":
            raise AssertionError(f"MIMIC serving{sfx}: K2f launched {launches} times")
        worst = 0.0
        for n, got in answers.items():
            want = ref.predict(requests[n])
            for a, w in [(got["logits"], want["logits"])] + list(zip(got["branch_logits"],
                                                                       want["branch_logits"])):
                err = float(np.abs(a - w).max())
                tol = BF16_REL * max(1.0, float(np.abs(w).max())) if bf16 else SERVED_ATOL
                if a.shape != w.shape or not np.isfinite(a).all() or not err <= tol:
                    raise AssertionError(f"MIMIC serving{sfx} n={n}: |err| {err} > {tol}")
                worst = max(worst, err)
        print(f"  MIMIC H serving{sfx} (export --pallas of the plain run's best weights, K2f "
              f"{launches} launches, against {'the same artifact on the CPU' if bf16 else 'the plain forward'}): "
              f"requests {list(REQUESTS)}, worst |err| {worst:.3e}")
        report["errors"][f"mimic_served{sfx}"] = worst
        report[f"mimic_serving_launches{sfx}"] = launches

    # one accumulated update: K = 4 micro-batches of 32 on the card and the CPU
    batches = [{k: v[i * 32:(i + 1) * 32] for k, v in requests[600].items()} for i in range(4)]
    for b in batches:
        b["label"] = rng.randint(0, 6, (32,)).astype(np.int32)
    result = {}
    for device in ("cuda", "cpu"):
        task, cfg = mimic_task(serving, apply_overrides, load_cfg, "stacked", False,
                               ["model.dropout=0.0", "train.grad_accum_steps=4"], device=device)
        if device == "cpu":
            task.network.load_state_dict(result["cuda"]["init"])
        trainer = Trainer(cfg.train, name=f"mimic_accum_{device}", work_dir=tmp)
        trainer.setup(task)
        ctx = task.make_ctx(0, "train")
        init = {k: v.detach().cpu().clone() for k, v in task.network.state_dict().items()}
        trainer.optimizer.zero_grad(set_to_none=True)
        losses = [trainer.micro_step(task, trainer._to_device(task, b), ctx)[0] for b in batches]
        grads = {n: (p.grad / 4).detach().cpu() for n, p in task.network.named_parameters()}
        trainer.apply_update(task, ctx, 4)
        moved = any(not torch.equal(init[n], p.detach().cpu())
                    for n, p in task.network.named_parameters())
        result[device] = {"init": init, "losses": torch.stack(losses).cpu(), "grads": grads,
                          "moved": moved}
        trainer.logger.close()
    g, c = result["cuda"], result["cpu"]
    if not (g["moved"] and c["moved"]):
        raise AssertionError("the accumulated update moved no parameter")
    key = "MIMIC accumulated update (K=4, micro-batch 32): micro-batch losses"
    report["errors"][key] = rel_err(torch, [g["losses"]], [c["losses"]], key, LOSS_REL)
    names = sorted(g["grads"])
    key = f"MIMIC accumulated update (K=4, micro-batch 32): {len(names)} averaged gradients"
    report["errors"][key] = grad_err(torch, [g["grads"][n] for n in names],
                                     [c["grads"][n] for n in names], key)


def phase_mimic_times(torch, mk, gk, serving, Trainer, apply_overrides, load_cfg, np, report):
    """CUDA events, median of 5 runs: K1f, K2f, K1b and K2b at the MIMIC
    fusion shape (batch 128 and 512, float32 and bf16) with their plain
    versions and bounds; the MIMIC H train step and served forward (plain
    modules, per-block and stacked kernel blocks; float32 as shipped and bf16
    with bench.py's levers; batch 128 and 512); K3f and K3b on the large-N
    route at 196 tokens (the config's widths, batch 32 and 512, float32 and
    bf16) with their plain versions, bounds, and the SGU's token product
    (B*F/2 x N) x (N x N) as one ``torch.matmul`` in the compute dtype."""
    print("[15/16] MIMIC and large-N gMLP times (CUDA events, median of 5 runs)")
    times, bounds = report["times_ms"], report["bounds_ms"]
    lib = report.setdefault("library_ms", {})
    geom = MIMIC_FUSION
    blocks, s, b = rand_blocks(mk, torch, 1, seed=72, **geom)
    flat = mk.stack_flat_params(blocks, s, b)
    for B in MIMIC_BATCHES:
        gen = torch.Generator().manual_seed(7)
        x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
        g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tag = f"mimic/B{B}/{dtype}"
            calls = {
                "K1f": lambda: mk.fused_mixer_block(x, blocks[0], compute_dtype=cd),
                "K1f_plain": lambda: mk.mixer_block_reference(x, blocks[0], compute_dtype=cd),
                "K2f": lambda: mk.fused_mixer_stack(x, flat, compute_dtype=cd),
                "K2f_plain": lambda: mk.mixer_stack_reference(x, flat, cd),
                "K1b": lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 1, 0.3, cd),
                "K1b_plain": lambda: mk.mixer_block_bwd_reference(x, g, blocks[0], 0.3, cd,
                                                                  seed=1),
                "K2b": lambda: mk.fused_mixer_stack_bwd(x, g, flat, 1, 0.3, cd),
                "K2b_plain": lambda: mk.mixer_stack_bwd_reference(x, g, flat, 0.3, cd, seed=1)}
            for name, fn in calls.items():
                times[f"{name}/{tag}"] = cuda_ms(torch, fn)
            peak = "bf16" if dtype == "bf16" else "f32"
            ffl, pbytes = block_work(B, **geom, wbytes=2 if dtype == "bf16" else 4)
            act = 2 * B * geom["N"] * geom["D"] * 4
            bfl, bbytes = bwd_work(B, **geom)
            bounds[f"K1f/{tag}"] = bound(ffl, pbytes + act, peak)
            bounds[f"K2f/{tag}"] = bound(ffl, pbytes + 8 * geom["D"] + act, peak)
            bounds[f"K1b/{tag}"] = bound(bfl, bbytes, peak)
            bounds[f"K2b/{tag}"] = bound(bfl, bbytes + 16 * geom["D"], peak)
            print(f"  {tag}: " + "; ".join(
                f"{n} {times[f'{n}/{tag}']:.4f} ms (plain {times[f'{n}_plain/{tag}']:.4f}, "
                f"bound {bounds[f'{n}/{tag}'][0]:.5f} {bounds[f'{n}/{tag}'][1]})"
                for n in ("K1f", "K2f", "K1b", "K2b")))
    rng = np.random.RandomState(8)
    data = {"static": rng.randn(512, 5).astype(np.float32),
            "time": rng.randn(512, 24, 12).astype(np.float32),
            "label": rng.randint(0, 6, (512,)).astype(np.int32)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mimic_steps_") as tmp:
        for bf16 in (False, True):
            for flavor in ("plain", "per_block", "stacked"):
                tag = f"{flavor}{'_bf16' if bf16 else ''}"
                task, cfg = mimic_task(serving, apply_overrides, load_cfg, flavor, bf16)
                trainer = Trainer(cfg.train, name=f"mimic_steps_{tag}", work_dir=tmp)
                trainer.setup(task)
                ctx = task.make_ctx(0, "train")
                fwd = serving.serve_fn(task)
                for B in MIMIC_BATCHES:
                    batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
                    times[f"mimic_train_step/{tag}/B{B}"] = cuda_ms(
                        torch, lambda: trainer.train_step(task, batch, ctx), iters=10)
                    feats = {k: v for k, v in batch.items() if k != "label"}
                    times[f"mimic_served/{tag}/B{B}"] = cuda_ms(torch, lambda: fwd(feats))
                trainer.logger.close()
                del task, trainer
    print("  MIMIC H train step / served forward: " + ", ".join(
        f"{k.split('/', 1)[1]} {v:.4f} ms" for k, v in times.items()
        if k.startswith(("mimic_train_step/", "mimic_served/"))))
    N = 196
    p = gmlp_params(gk, torch, N=N, seed=40, **GMLP_LARGE)
    H = GMLP_LARGE["F"] // 2
    for B in (32, 512):
        gen = torch.Generator().manual_seed(9)
        x = torch.randn(B, N, GMLP_LARGE["D"], generator=gen).cuda()
        g = torch.randn(B, N, GMLP_LARGE["D"], generator=gen).cuda()
        flops, pbytes = gmlp_work(B, N, **GMLP_LARGE)
        act = B * N * GMLP_LARGE["D"] * 4
        for dtype, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tag = f"N{N}/B{B}/{dtype}"
            calls = {"K3f": lambda: gk.fused_gmlp_block(x, p, compute_dtype=cd),
                     "K3f_plain": lambda: gk.gmlp_block_reference(x, p, compute_dtype=cd),
                     "K3b": lambda: gk.fused_gmlp_block_bwd(x, g, p, compute_dtype=cd),
                     "K3b_plain": lambda: gk.gmlp_block_bwd_reference(x, g, p,
                                                                      compute_dtype=cd)}
            for name, fn in calls.items():
                times[f"{name}/{tag}"] = cuda_ms(torch, fn, iters=5)
            peak, wbytes = ("bf16", pbytes // 2) if dtype == "bf16" else ("f32", pbytes)
            bounds[f"K3f/{tag}"] = bound(flops, wbytes + 2 * act, peak)
            bounds[f"K3b/{tag}"] = bound(2 * flops, wbytes + pbytes + 3 * act, peak)
            a = torch.randn(B * H, N, device="cuda").to(cd)
            w = torch.randn(N, N, device="cuda").to(cd)
            lib[f"K3_sgu_token_product/{tag}"] = cuda_ms(torch, lambda: torch.matmul(a, w))
            print(f"  K3 large-N {tag}: " + "; ".join(
                f"{n} {times[f'{n}/{tag}']:.4f} ms (plain {times[f'{n}_plain/{tag}']:.4f}, "
                f"bound {bounds[f'{n}/{tag}'][0]:.4f} {bounds[f'{n}/{tag}'][1]})"
                for n in ("K3f", "K3b")) + f"; the SGU token product as one torch.matmul "
                f"{lib[f'K3_sgu_token_product/{tag}']:.4f} ms")
            del calls, a, w
        torch.cuda.empty_cache()


def phase_gmlp_p8(torch, gk, serving, apply_overrides, load_cfg, np, report):
    """The large-N route on a main path: the gMLP config with the audio
    encoder at patch 8 (196 tokens; the fusion stack then holds 246), depth
    cut to 2 + 2 + 2 blocks, through PallasVisiongMLP / PallasFusiongMLP, in
    float32 and bf16: one training step (dropout 0, stochastic depth pinned
    off) on the card against the CPU, the losses and every gradient within
    GRAD_REL (float32) or BF16_REL (bf16) x max(1, max|CPU|), then one served
    forward of 32 samples; the K3f/K3b counters zeroed just before and read
    just after, and the tallies' gmlp_vt_kernel launches: one a K3f and one
    a K3b call (every block above 128 tokens)."""
    print("[11/16] the gMLP config at audio patch 8 (196 + 246 tokens, the large-N route), "
          "depth cut to 2 + 2 + 2: a training step on the card against the CPU, a served "
          "forward")
    over = ["model.modalities.audio.patch_size=8", "model.dropout=0.0", *GMLP_NO_DEPTH_DROP,
            *(f"model.modalities.{k}.n_blocks=2" for k in ("image", "audio", "multimodal")),
            *GMLP_KERNEL_BLOCKS]
    rng = np.random.RandomState(11)
    batch = {"image": rng.rand(32, 1, 28, 28).astype(np.float32),
             "audio": rng.rand(32, 1, 112, 112).astype(np.float32),
             "label": rng.randint(0, 10, (32,)).astype(np.int32)}
    launches = report["gmlp_p8_launches"] = {}
    for dtype in ("f32", "bf16"):
        extra = over + (["model.precision=bf16"] if dtype == "bf16" else [])
        tasks = {}
        for device in ("cuda", "cpu"):
            cfg = load_cfg(GMLP_CFG)
            apply_overrides(cfg, extra, warn=False)
            tasks[device] = serving._build_task(cfg, device=device)
        tasks["cpu"].network.load_state_dict(tasks["cuda"].network.state_dict())
        gk.fused_gmlp_block.launches = gk.fused_gmlp_block_bwd.launches = 0
        (g_losses, g_grads), counts = tallied(torch, lambda: train_step_one(
            torch, tasks["cuda"], {k: torch.from_numpy(v).cuda() for k, v in batch.items()}))
        step = {"K3f": gk.fused_gmlp_block.launches, "K3b": gk.fused_gmlp_block_bwd.launches,
                "gmlp_vt_kernel": counts["gmlp_vt_kernel"]}
        c_losses, c_grads = train_step_one(torch, tasks["cpu"],
                                           {k: torch.from_numpy(v) for k, v in batch.items()})
        rel = BF16_REL if dtype == "bf16" else GRAD_REL
        key = f"gMLP p8 step/{dtype}: loss, branch losses"
        report["errors"][key] = rel_err(torch, torch.stack(g_losses).cpu(),
                                        torch.stack(c_losses), key, rel)
        names = sorted(g_grads)
        key = f"gMLP p8 step/{dtype}: {len(names)} parameter gradients"
        report["errors"][key] = rel_err(torch, [g_grads[n].cpu() for n in names],
                                        [c_grads[n] for n in names], key, rel)
        fwd = serving.serve_fn(tasks["cuda"])
        feats = {k: torch.from_numpy(v).cuda() for k, v in batch.items() if k != "label"}
        gk.fused_gmlp_block.launches = 0
        _, counts = tallied(torch, lambda: fwd(feats))
        served = {"K3f": gk.fused_gmlp_block.launches, "gmlp_vt_kernel": counts["gmlp_vt_kernel"]}
        print(f"  {dtype}: step launches {step}, served forward {served}")
        if not (step["K3f"] == 6 and step["K3b"] == 6 and step["gmlp_vt_kernel"] == 8
                and served == {"K3f": 6, "gmlp_vt_kernel": 4}):
            raise AssertionError(f"gMLP p8 {dtype}: the large-N route's launches {step} {served}")
        launches[dtype] = {"step": step, "served": served}
        del tasks


def slice_kernels(report) -> list:
    """The kernels line's rows of this slice: K1f, K2f, K1b and K2b at the MIMIC
    H fusion shape (batch 512, float32 and bf16; launches from the 2-epoch
    MIMIC runs), K3f and K3b on the large-N route (196 tokens, batch 512,
    float32 and bf16; launches from the audio-patch-8 gMLP step and served
    forward, max |err| from the batch-32 checks)."""
    t, bd, lib = report["times_ms"], report["bounds_ms"], report["library_ms"]
    runs = report["mimic_launches"]
    rows = []
    for dtype in ("f32", "bf16"):
        tag = f"mimic/B512/{dtype}"
        sfx = "_bf16" if dtype == "bf16" else ""
        for k, src, what in (("K1f", "mixer_fwd.cu", "one MixerBlock"),
                             ("K2f", "mixer_fwd.cu", "1 MixerBlock + LN"),
                             ("K1b", "mixer_bwd.cu", "one MixerBlock backward"),
                             ("K2b", "mixer_bwd.cu", "1 MixerBlock + LN backward")):
            rows.append({
                "name": f"{'mixer_fwd' if k.endswith('f') else 'mixer_bwd'} {dtype} ({k}, {what}, "
                        "MIMIC H fusion: B=512 N=25 D=64 T=8 C=64, the token FF in registers)",
                "route": "cuda", "source": f"m2mixer_tpu_torch/ops/csrc/{src}",
                "replaces": {"K1f": "m2mixer_tpu/ops/mixer_kernel.py:213",
                             "K2f": "m2mixer_tpu/ops/mixer_kernel.py:421",
                             "K1b": "m2mixer_tpu/ops/mixer_kernel.py:267",
                             "K2b": "m2mixer_tpu/ops/mixer_kernel.py:506"}[k],
                "launches": runs[f"{k}{sfx}"], "max_abs_err": report["errors"][f"{k}/{tag}"],
                "ms": t[f"{k}/{tag}"], "plain_ms": t[f"{k}_plain/{tag}"],
                "bound_ms": bd[f"{k}/{tag}"][0], "bound_by": bd[f"{k}/{tag}"][1],
                "library_ms": None})
        tag = f"N196/B512/{dtype}"
        p8 = report["gmlp_p8_launches"][dtype]
        for k, line, what in (("K3f", 134, "one gMLP block"),
                              ("K3b", 167, "one gMLP block backward")):
            rows.append({
                "name": f"gmlp_{'fwd' if k == 'K3f' else 'bwd'} {dtype} large-N route ({k}, "
                        f"{what}, B=512 N=196 D=128 F=768: the SGU's token products over "
                        "the B*F/2 rows)",
                "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/gmlp.cu",
                "replaces": f"m2mixer_tpu/ops/gmlp_kernel.py:{line}",
                "launches": (p8["step"]["K3f"] + p8["served"]["K3f"] if k == "K3f"
                             else p8["step"]["K3b"]),
                "max_abs_err": report["errors"][f"{k}/N196/F768/B32/{dtype}"],
                "ms": t[f"{k}/{tag}"], "plain_ms": t[f"{k}_plain/{tag}"],
                "bound_ms": bd[f"{k}/{tag}"][0], "bound_by": bd[f"{k}/{tag}"][1],
                "library_ms": lib[f"K3_sgu_token_product/{tag}"]})
    return rows


# ------------------------------------------- yardsticks, registers, A/B times
def product_yardsticks(torch, report) -> None:
    """Each product of K1b, K3f, K3b, K4f and K4b at batch 512 timed as one
    ``torch.matmul`` in float32 (TF32 off), each of K1b's also as one bf16
    ``torch.matmul`` (the bf16 K1b's yardstick; at the B shapes and the L
    fusion shape), and the bf16 K1f's four (the channel FF's up and down, the
    token FF's up and down) as one bf16 ``torch.matmul`` each at the three L
    shapes, and bf16 K3f's and K3b's six (in_proj, out_proj, dgated, dxn,
    dW_in, dW_out) as one bf16 ``torch.matmul`` each at both gMLP shapes: a
    yardstick per product, never called by the port; likewise bf16 K4f's
    three and K4b's six products (compress, generate, out_proj, d_mixed,
    d_gin, dx_comp, dW_c, dW_g, dW_o) as one bf16 ``torch.matmul`` each. Shapes
    (M x K x N); the SGU's token products are batched over the sample's F/2
    v-channels. K3f's in-projection and token
    product are K3b's in_proj and sgu t."""
    print("  per-product yardsticks, torch.matmul float32 (TF32 off), batch 512:")
    ys = report["product_library_ms"] = {}

    def mm(name, M, K, N, dtype=torch.float32):
        a = torch.randn(M, K, device="cuda").to(dtype)
        b = torch.randn(K, N, device="cuda").to(dtype)
        ys[name] = cuda_ms(torch, lambda: torch.matmul(a, b))
        print(f"    {ys[name]:.4f} ms  {name} ({M} x {K} x {N})")

    for geom_name, geom in (("encoder", ENC), ("fusion", FUSION)):
        R, D, C = 512 * geom["N"], geom["D"], geom["C"]
        for prod, (M, K, Nn) in {"a3": (R, D, C), "dh2": (R, D, C), "dz": (R, C, D),
                                 "dW3": (D, R, C), "dW4": (C, R, D)}.items():
            mm(f"K1b/{geom_name}/B512/{prod}", M, K, Nn)
            # the bf16 K1b's product of the same shape as one bf16 torch.matmul
            mm(f"K1b_bf16/{geom_name}/B512/{prod} (bf16 matmul)", M, K, Nn, torch.bfloat16)
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        N, D, F = geom["N"], geom["D"], geom["F"]
        R, H = 512 * N, F // 2
        for prod, (M, K, Nn) in {"in_proj": (R, D, F), "dgated": (R, D, H), "dxn": (R, F, D),
                                 "dW_in": (D, R, F), "dW_out": (H, R, D),
                                 "sgu t": (512 * H, N, N), "sgu dv'": (512 * H, N, N),
                                 "sgu d sgu_w": (N, 512 * H, N)}.items():
            mm(f"K3b/{geom_name}/B512/{prod}", M, K, Nn)
        mm(f"K3f/{geom_name}/B512/out_proj", R, H, D)
        # bf16 K3f's and K3b's products of these shapes as one bf16 matmul each
        for prod, (M, K, Nn) in {"in_proj": (R, D, F), "out_proj": (R, H, D),
                                 "dgated": (R, D, H), "dxn": (R, F, D), "dW_in": (D, R, F),
                                 "dW_out": (H, R, D)}.items():
            mm(f"K3_bf16/{geom_name}/B512/{prod} (bf16 matmul)", M, K, Nn, torch.bfloat16)
    # the bf16 K1b's channel products at the L fusion shape, one bf16 matmul each
    lf = L_GEOMS[2][1]
    R, D, C = 512 * lf["N"], lf["D"], lf["C"]
    for prod, (M, K, Nn) in {"a3": (R, D, C), "dh2": (R, D, C), "dz": (R, C, D),
                             "dW3": (D, R, C), "dW4": (C, R, D)}.items():
        mm(f"K1b_bf16/L_fusion/B512/{prod} (bf16 matmul)", M, K, Nn, torch.bfloat16)
    # the bf16 K1f's four products at the three L shapes, one bf16 matmul each
    for geom_name, geom, _ in L_GEOMS:
        N, D, T, C = geom["N"], geom["D"], geom["T"], geom["C"]
        R, rows = 512 * N, 512 * D
        for prod, (M, K, Nn) in {"up": (R, D, C), "down": (R, C, D), "token_up": (rows, N, T),
                                 "token_down": (rows, T, N)}.items():
            mm(f"K1f_bf16/L_{geom_name}/B512/{prod} (bf16 matmul)", M, K, Nn, torch.bfloat16)
    rows, C, HR = 7 * 512 * DYNA_OP["L"], DYNA_OP["C"], DYNA_OP["H"] * DYNA_OP["R"]
    mm("K4f/B512/out_proj", rows, C, C)
    for prod, (M, K, Nn) in {"d_mixed": (rows, C, C), "dW_o": (C, rows, C),
                             "dW_c": (C, rows, HR)}.items():
        mm(f"K4b/B512/{prod}", M, K, Nn)
    # bf16 K4f's three and K4b's six engine products, one bf16 matmul each
    units, LR, LL = 7 * 512 * DYNA_OP["H"], DYNA_OP["L"] * DYNA_OP["R"], DYNA_OP["L"] ** 2
    for prod, (M, K, Nn) in {"compress": (rows, C, HR), "generate": (units, LR, LL),
                             "out_proj": (rows, C, C), "d_mixed": (rows, C, C),
                             "d_gin": (units, LL, LR), "dx_comp": (rows, HR, C),
                             "dW_c": (C, rows, HR), "dW_g": (LL, units, LR),
                             "dW_o": (C, rows, C)}.items():
        mm(f"K4_bf16/B512/{prod} (bf16 matmul)", M, K, Nn, torch.bfloat16)


def ptxas_usage(log: str) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from an
    ``nvcc -Xptxas -v`` log, names shortened to file::function<template args>."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = short_kernel_name(m.group(1))
            usage[name] = [None, 0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name][0] = int(m.group(1))
    return usage


def short_kernel_name(mangled: str) -> str:
    """'_ZN<len>_GLOBAL__N__<id>_<file>_cu_<id><len><name>I<args>E...' ->
    'file.cu::name<args>' (template integers and type names kept)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    ns_end = m.end() + int(m.group(1))
    src = re.search(r"_\d+_(\w+?)_cu_", mangled[:ns_end])
    rest = mangled[ns_end:]
    n = re.match(r"(\d+)", rest)
    func = rest[n.end():n.end() + int(n.group(1))] if n else rest
    args = rest[n.end() + int(n.group(1)):] if n else ""
    targs = re.findall(r"L[ib](\d+)E|(Epi\w+?)E", args.split("EEv")[0] + "EEv")
    targ = ",".join(a or b for a, b in targs)
    return f"{src.group(1) if src else '?'}.cu::{func}" + (f"<{targ}>" if targ else "")


def build_kernels(_build, report) -> None:
    """Build with ptxas's report; print every kernel's registers and spills."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _build.build_library(verbose=True)
    log = buf.getvalue()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "build_ptxas.log"), "w") as f:
        f.write(log)
    usage = report["registers_spills"] = ptxas_usage(log)
    print(f"  {len(usage)} kernels (registers, spill store / load bytes):")
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"    {regs:4}  {st}/{ld}  {name}")


def host_us(torch, fn, calls: int = 20) -> float:
    """Host time (µs) to enqueue one call of ``fn``, the mean over ``calls``
    calls in a row after a warm-up: where it exceeds the call's CUDA-event
    time, the host and not the card sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def kernel_times(torch, mk, gk, dk) -> dict:
    """K1f, K2f, K1b and K2b (encoder and fusion stack; each also in bf16
    compute), K3f and K3b (encoder and fusion shape), K4f and K4b alone
    at batch 32 and 512 (CUDA events,
    median of 5 runs of 20 calls; the forwards float32 without dropout, as
    served), bf16 K1b and K2b (2 blocks + LN) at the L fusion shape at
    batch 512 (5 calls a run) with the device time of each launch of one call
    in launch order and, for K1b, the sum of its five channel products
    (``channel_products``), and bf16 K1f and K2f at the three L shapes at
    batch 512 the same way (K1f's two channel products summed,
    ``fwd_channel_products``), the numbers the A/B compares; for one K1f call
    (float32 and bf16; bf16 also summed, ``/device``) at each shape at batch
    512, and one K1b call at each shape and batch, the device time of each
    launch; and the host time to enqueue one K1b, bf16 K1f (at 512), bf16 K3f
    and K3b call, and one K4f and K4b call in either dtype."""
    times, breakdown, host = {}, {}, {}
    for geom_name, geom, K in MIXER_STACKS:
        blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=13, **geom)
        flat = mk.stack_flat_params(blocks, ln_s, ln_b)
        for B in (32, 512):
            x = torch.randn(B, geom["N"], geom["D"], generator=torch.Generator().manual_seed(3)).cuda()
            k1f = lambda: mk.fused_mixer_block(x, blocks[0])
            times[f"K1f/{geom_name}/B{B}"] = cuda_ms(torch, k1f)
            times[f"K2f/{geom_name}/B{B}"] = cuda_ms(torch, lambda: mk.fused_mixer_stack(x, flat))
            bf = torch.bfloat16
            k1f_bf16 = lambda: mk.fused_mixer_block(x, blocks[0], compute_dtype=bf)
            times[f"K1f_bf16/{geom_name}/B{B}"] = cuda_ms(torch, k1f_bf16)
            times[f"K2f_bf16/{geom_name}/B{B}"] = cuda_ms(
                torch, lambda: mk.fused_mixer_stack(x, flat, compute_dtype=bf))
            if B == 512:
                breakdown[f"K1f/{geom_name}/B{B}"] = kernel_breakdown(torch, k1f, None)
                key = f"K1f_bf16/{geom_name}/B{B}"
                breakdown[key] = kernel_breakdown(torch, k1f_bf16, None)
                times[f"{key}/device"] = sum(us for us, _ in breakdown[key].values()) / 1e3
                host[key] = host_us(torch, k1f_bf16)
        for B in (32, 512):
            calls = mixer_bwd_calls(torch, mk, geom, K, B)
            for name in ("K1b", "K2b", "K1b_bf16", "K2b_bf16"):
                times[f"{name}/{geom_name}/B{B}"] = cuda_ms(torch, calls[name])
            breakdown[f"K1b/{geom_name}/B{B}"] = kernel_breakdown(torch, calls["K1b"], None)
            host[f"K1b/{geom_name}/B{B}"] = host_us(torch, calls["K1b"])
    for geom_name, geom in (("encoder", GMLP_ENC), ("fusion", GMLP_FUSION)):
        p = gmlp_params(gk, torch, seed=33, **geom)
        for B in (32, 512):
            gen = torch.Generator().manual_seed(6)
            x = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            g = torch.randn(B, geom["N"], geom["D"], generator=gen).cuda()
            times[f"K3f/{geom_name}/B{B}"] = cuda_ms(torch, lambda: gk.fused_gmlp_block(x, p))
            times[f"K3b/{geom_name}/B{B}"] = cuda_ms(torch, lambda: gk.fused_gmlp_block_bwd(x, g, p))
            # bf16 K3f and K3b: each launch of one call in order, the products summed
            bf = torch.bfloat16
            calls = {"K3f_bf16": lambda: gk.fused_gmlp_block(x, p, compute_dtype=bf),
                     "K3b_bf16": lambda: gk.fused_gmlp_block_bwd(x, g, p, compute_dtype=bf)}
            for name, fn in calls.items():
                key = f"{name}/{geom_name}/B{B}"
                times[key] = cuda_ms(torch, fn)
                breakdown[key] = launch_sequence(torch, fn)
                times[f"{key}/products"] = sum(
                    us for _, us in product_launches(breakdown[key])) / 1e3
                host[key] = host_us(torch, fn)
    # bf16 K1b and K2b (the 2 blocks + LN) at the L fusion shape, batch 512: the
    # redesigned route's main cost, with each launch of one call
    geom = L_GEOMS[2][1]
    blocks, ln_s, ln_b = rand_blocks(mk, torch, 2, seed=53, **geom)
    flat = mk.stack_flat_params(blocks, ln_s, ln_b)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(512, geom["N"], geom["D"], generator=gen).cuda()
    g = torch.randn(512, geom["N"], geom["D"], generator=gen).cuda()
    with torch.no_grad():
        _, saved = mk._stack_forward(x, flat, 1, 0.5, torch.bfloat16, True, False, save=True)
    calls = {"K1b_bf16": lambda: mk.fused_mixer_block_bwd(x, g, blocks[0], 1, 0.5, torch.bfloat16),
             "K2b_bf16": lambda: mk.fused_mixer_stack_bwd(x, g, flat, 1, 0.5, torch.bfloat16,
                                                          saved=saved)}
    for name, fn in calls.items():
        key = f"{name}/L_fusion/B512"
        times[key] = cuda_ms(torch, fn, iters=5)
        breakdown[key] = launch_sequence(torch, fn)
        if name == "K1b_bf16":
            prods = channel_products(breakdown[key])
            times[f"{key}/channel_products"] = sum(us for _, us in prods) / 1e3
    del x, g, saved, calls, blocks, flat
    torch.cuda.empty_cache()
    # bf16 K1f and K2f (the main path's depth + LN) at the three L shapes, batch
    # 512, as served: each launch of one call, and K1f's two channel products
    for geom_name, geom, K in L_GEOMS:
        blocks, ln_s, ln_b = rand_blocks(mk, torch, K, seed=53, **geom)
        flat = mk.stack_flat_params(blocks, ln_s, ln_b)
        x = torch.randn(512, geom["N"], geom["D"], generator=torch.Generator().manual_seed(5)).cuda()
        calls = {"K1f_bf16": lambda: mk.fused_mixer_block(x, blocks[0],
                                                          compute_dtype=torch.bfloat16),
                 "K2f_bf16": lambda: mk.fused_mixer_stack(x, flat, compute_dtype=torch.bfloat16)}
        for name, fn in calls.items():
            key = f"{name}/L_{geom_name}/B512"
            times[key] = cuda_ms(torch, fn, iters=5)
            breakdown[key] = launch_sequence(torch, fn)
            if name == "K1f_bf16":
                prods = fwd_channel_products(kernel_breakdown(torch, fn, None))
                times[f"{key}/channel_products"] = sum(us for _, us in prods) / 1e3
        del x, calls, blocks, flat
        torch.cuda.empty_cache()
    H, R = DYNA_OP["H"], DYNA_OP["R"]
    p = dyna_params(dk, torch, seed=43, **DYNA_OP)
    try:
        dk.fused_dynamixer_op(torch.zeros(1, DYNA_OP["L"], DYNA_OP["C"], device="cuda"), p, H, R)
    except ValueError:  # a checkout from before the kernels read the weights output-major
        p = dk.DynaMixerOpParams(*(t.t().contiguous() if t.dim() == 2 else t for t in p))
    for B in (32, 512):
        gen = torch.Generator().manual_seed(7)
        x = torch.randn(7 * B, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        g = torch.randn(7 * B, DYNA_OP["L"], DYNA_OP["C"], generator=gen).cuda()
        calls = {"K4f": lambda: dk.fused_dynamixer_op(x, p, H, R),
                 "K4b": lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R)}
        for name, fn in calls.items():
            times[f"{name}/B{B}"] = cuda_ms(torch, fn)
            host[f"{name}/B{B}"] = host_us(torch, fn)
        # bf16 K4f and K4b: at 512 each launch of one call in order, the products summed
        bf = torch.bfloat16
        calls = {"K4f_bf16": lambda: dk.fused_dynamixer_op(x, p, H, R, compute_dtype=bf),
                 "K4b_bf16": lambda: dk.fused_dynamixer_op_bwd(x, g, p, H, R, compute_dtype=bf)}
        for name, fn in calls.items():
            key = f"{name}/B{B}"
            times[key] = cuda_ms(torch, fn)
            host[key] = host_us(torch, fn)
            if B == 512:
                breakdown[key] = launch_sequence(torch, fn)
                times[f"{key}/products"] = sum(
                    us for _, us in product_launches(breakdown[key])) / 1e3
    return {"kernel_times": times, "breakdown_us": breakdown, "host_us": host}


def dyna_bf16_e2e_times(torch, np, serving, Trainer, apply_overrides, load_cfg,
                        synthetic) -> dict:
    """The DynaMixer config at ``model.precision=bf16``, full width and depth,
    seeded weights: the served forward (40 bf16 K4f) and the train step (the
    config's dropout 0.5, Adam; 40 bf16 K4f and K4b) at batch 32 and 512
    (CUDA events, median of 5 runs of 5; the served forward at 32 of 5 runs
    of 20), and the served forward's device time (its kernels' profiler
    sum, ``/device``)."""
    times = {}
    cfg = load_cfg(DYNA_CFG)
    apply_overrides(cfg, ["model.precision=bf16"], warn=False)
    data = synthetic(512, seed=4, learnable=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dyna_e2e_") as tmp:
        task = serving._build_task(cfg, device="cuda")
        fn = serving.serve_fn(task)
        rng = np.random.RandomState(3)
        for B in (32, 512):
            feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                     "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
            # at 32 more calls a run: the host paces it, and its time spreads
            times[f"dyna_bf16_served/B{B}"] = cuda_ms(torch, lambda: fn(feats),
                                                      iters=5 if B == 512 else 20)
            times[f"dyna_bf16_served/B{B}/device"] = device_busy_ms(torch, lambda: fn(feats))
        trainer = Trainer(cfg.train, name="dyna_bf16_e2e", work_dir=tmp)
        trainer.setup(task)
        ctx = task.make_ctx(0, "train")
        for B in (32, 512):
            batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
            times[f"dyna_bf16_train_step/B{B}"] = cuda_ms(
                torch, lambda: trainer.train_step(task, batch, ctx), iters=5)
        trainer.logger.close()
        del task, trainer
    torch.cuda.empty_cache()
    return times


def l_e2e_times(torch, np, serving, Trainer, apply_overrides, load_cfg, synthetic) -> dict:
    """The L config (bf16) at full width, seeded weights: the served forward
    at batch 32 and 512 through the plain modules and through the network
    ``serving export --pallas`` builds (``PallasStacked*``: three bf16 K2f
    stacks), and the train step at 512 (the config's dropout 0.5) through
    ``PallasStacked*`` and ``Pallas*`` (CUDA events, median of 5 runs of 5)."""
    times = {}
    plain, cfg = l_task(serving, apply_overrides, load_cfg, "plain")
    kernel, _ = serving.to_torch_kernel_serving(cfg, plain.network.state_dict(), device="cuda")
    rng = np.random.RandomState(5)
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        for flavor, task in (("plain", plain), ("stacked", kernel)):
            fn = serving.serve_fn(task)
            times[f"l_served/{flavor}/B{B}"] = cuda_ms(torch, lambda: fn(feats), iters=5)
    del plain, kernel
    data = synthetic(512, seed=4, learnable=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_l_e2e_") as tmp:
        for flavor in ("stacked", "per_block"):
            task, cfg = l_task(serving, apply_overrides, load_cfg, flavor)
            trainer = Trainer(cfg.train, name=f"l_e2e_{flavor}", work_dir=tmp)
            trainer.setup(task)
            ctx = task.make_ctx(0, "train")
            times[f"l_train_step/{flavor}/B512"] = cuda_ms(
                torch, lambda: trainer.train_step(task, batch, ctx), iters=5)
            trainer.logger.close()
            del task, trainer
            torch.cuda.empty_cache()
    return times


def gmlp_bf16_e2e_times(torch, np, serving, Trainer, apply_overrides, load_cfg,
                        synthetic) -> dict:
    """The gMLP config at ``model.precision=bf16``, full width and depth,
    seeded weights: the served forward at batch 32 and 512 through the plain
    modules and through the network ``serving export --pallas`` builds (75
    bf16 K3f), and the train step (the config otherwise unchanged: dropout 0,
    stochastic depth on) through the kernel blocks at 32 and 512 (CUDA
    events, median of 5 runs of 5 and 3)."""
    times = {}
    cfg = load_cfg(GMLP_CFG)
    apply_overrides(cfg, ["model.precision=bf16"], warn=False)
    plain = serving._build_task(cfg, device="cuda")
    kernel, _ = serving.to_torch_kernel_serving(cfg, plain.network.state_dict(), device="cuda")
    rng = np.random.RandomState(3)
    for B in (32, 512):
        feats = {"image": torch.from_numpy(rng.rand(B, 1, 28, 28).astype(np.float32)).cuda(),
                 "audio": torch.from_numpy(rng.rand(B, 1, 112, 112).astype(np.float32)).cuda()}
        for flavor, task in (("plain", plain), ("kernel", kernel)):
            fn = serving.serve_fn(task)
            times[f"gmlp_bf16_served/{flavor}/B{B}"] = cuda_ms(torch, lambda: fn(feats), iters=5)
    del plain, kernel
    data = synthetic(512, seed=4, learnable=True)
    cfg = load_cfg(GMLP_CFG)
    apply_overrides(cfg, ["model.precision=bf16", *GMLP_KERNEL_BLOCKS], warn=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_e2e_") as tmp:
        task = serving._build_task(cfg, device="cuda")
        trainer = Trainer(cfg.train, name="gmlp_bf16_e2e", work_dir=tmp)
        trainer.setup(task)
        ctx = task.make_ctx(0, "train")
        for B in (32, 512):
            batch = {k: torch.from_numpy(v[:B]).cuda() for k, v in data.items()}
            times[f"gmlp_bf16_train_step/kernel/B{B}"] = cuda_ms(
                torch, lambda: trainer.train_step(task, batch, ctx), iters=3)
        trainer.logger.close()
        del task, trainer
    torch.cuda.empty_cache()
    return times


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def ab_times(parent: str) -> int:
    """The eight kernels' times (and K1f's and K1b's breakdowns), the B
    served forward and the B train step of the checkout at ``parent``
    against this one's on this card, in turns (parent, this, this, parent),
    each in its own process."""
    runs = []
    for root in (parent, REPO, REPO, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel-times",
                              "--root", root], capture_output=True, text=True, check=True,
                             timeout=900).stdout.strip().splitlines()[-1]
        runs.append({"root": root, **json.loads(out)})
        print(f"  {root}: {json.dumps(runs[-1]['kernel_times'])} {json.dumps(runs[-1]['e2e_ms'])}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump({"card": card_line(), "runs": runs}, f, indent=2)
    print(card_line())
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description="chip smoke test of the port (no arguments: all "
                                 "phases)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build and print the eight kernels' times as one JSON line")
    ap.add_argument("--root", default=REPO, help="checkout whose m2mixer_tpu_torch is timed "
                    "(with --kernel-times)")
    ap.add_argument("--ab", metavar="PARENT",
                    help="the eight kernels' times of the checkout PARENT against this one, "
                    "in turns")
    args = ap.parse_args()
    if args.ab:
        return ab_times(os.path.abspath(args.ab))
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from m2mixer_tpu_torch import run, serving
    from m2mixer_tpu_torch.config import apply_cli_overrides
    from m2mixer_tpu_torch.config import load as load_cfg
    from m2mixer_tpu_torch.datasets import synthetic_avmnist_arrays
    from m2mixer_tpu_torch.models import get_model
    from m2mixer_tpu_torch.ops import _build
    from m2mixer_tpu_torch.ops import dynamixer_kernel as dk
    from m2mixer_tpu_torch.ops import gmlp_kernel as gk
    from m2mixer_tpu_torch.ops import mixer_kernel as mk
    from m2mixer_tpu_torch.training.trainer import Trainer

    if args.kernel_times:
        _build.load_library()
        fwd = {flavor: serving.serve_fn(kernel_task(serving, apply_cli_overrides, load_cfg,
                                                    flavor)[0])
               for flavor in ("plain", "stacked", "per_block")}
        e2e = b_served_times(torch, np, fwd)
        e2e.update(b_train_step_times(torch, serving, Trainer, apply_cli_overrides, load_cfg,
                                      synthetic_avmnist_arrays))
        e2e.update(l_e2e_times(torch, np, serving, Trainer, apply_cli_overrides, load_cfg,
                               synthetic_avmnist_arrays))
        e2e.update(gmlp_bf16_e2e_times(torch, np, serving, Trainer, apply_cli_overrides, load_cfg,
                                       synthetic_avmnist_arrays))
        e2e.update(dyna_bf16_e2e_times(torch, np, serving, Trainer, apply_cli_overrides, load_cfg,
                                       synthetic_avmnist_arrays))
        print(json.dumps({**kernel_times(torch, mk, gk, dk), "e2e_ms": e2e, "card": card_line()}))
        return 0
    t_start = time.time()
    report = {"errors": {}, "bf16_checks": {}, "times_ms": {}, "bounds_ms": {}}
    print("[1/16] building the CUDA kernels")
    t0 = time.time()
    build_kernels(_build, report)
    _build.load_library()
    report["build_seconds"] = time.time() - t0
    print(f"  build seconds: {report['build_seconds']:.1f}")

    phase_kernels(torch, mk, report)
    phase_backward(torch, mk, report)
    phase_bf16_backward(torch, mk, report)
    phase_mixer_widths(torch, mk, report)
    phase_l_kernels(torch, mk, report)
    phase_mimic_kernels(torch, mk, report)
    phase_gmlp_kernels(torch, gk, report)
    phase_gmlp_bf16_kernels(torch, gk, report)
    phase_gmlp_widths(torch, gk, report)
    phase_gmlp_large_n(torch, gk, report)
    phase_dyna_kernels(torch, dk, report)
    phase_dyna_bf16_kernels(torch, dk, report)
    phase_error_rows(torch, mk, gk, dk, _build.load_library(), report)
    plain, models = phase_serving(torch, mk, serving, get_model, load_cfg, np, report)
    gmlp_served = dict(zip(("plain", "kernel"), phase_gmlp_serving(torch, gk, serving, np, report)))
    dyna_served = phase_dyna_serving(torch, dk, serving, np, report)
    phase_training(torch, mk, serving, run, apply_cli_overrides, load_cfg,
                   synthetic_avmnist_arrays, np, report)
    turbo_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_turbo_")
    turbo_weights = phase_turbo_training(torch, mk, serving, run, apply_cli_overrides, load_cfg,
                                         synthetic_avmnist_arrays, np, report, turbo_tmp.name)
    turbo_served = phase_turbo_serving(torch, mk, serving, load_cfg, np, report, turbo_weights,
                                       turbo_tmp.name)
    l_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_l_")
    l_served = phase_l_training(torch, mk, serving, run, apply_cli_overrides, load_cfg,
                                synthetic_avmnist_arrays, np, report, l_tmp.name)
    phase_gmlp_training(torch, gk, serving, run, apply_cli_overrides, load_cfg,
                        synthetic_avmnist_arrays, np, report)
    gmlp_bf16_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_gmlp_bf16_")
    gmlp_bf16_served = phase_gmlp_bf16_training(torch, gk, serving, run, apply_cli_overrides,
                                                load_cfg, synthetic_avmnist_arrays, np, report,
                                                gmlp_bf16_tmp.name)
    phase_dyna_training(torch, dk, serving, run, apply_cli_overrides, load_cfg,
                        synthetic_avmnist_arrays, np, report)
    dyna_bf16_served = phase_dyna_bf16(torch, dk, serving, run, np, report)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mimic_") as tmp:
        phase_mimic(torch, mk, serving, run, Trainer, apply_cli_overrides, load_cfg, np, report,
                    tmp)
    phase_gmlp_p8(torch, gk, serving, apply_cli_overrides, load_cfg, np, report)
    phase_times(torch, mk, serving, np, plain, models, report)
    phase_train_times(torch, mk, serving, Trainer, apply_cli_overrides, load_cfg,
                      synthetic_avmnist_arrays, report)
    phase_gmlp_times(torch, gk, serving, Trainer, apply_cli_overrides, load_cfg,
                     synthetic_avmnist_arrays, np, gmlp_served, report)
    phase_gmlp_bf16_times(torch, gk, serving, Trainer, apply_cli_overrides, load_cfg,
                          synthetic_avmnist_arrays, np, gmlp_bf16_served, report)
    gmlp_bf16_tmp.cleanup()
    phase_dyna_times(torch, dk, serving, Trainer, load_cfg, synthetic_avmnist_arrays, np,
                     dyna_served, report)
    phase_bf16_times(torch, mk, serving, Trainer, apply_cli_overrides, load_cfg,
                     synthetic_avmnist_arrays, np, report, turbo_served)
    turbo_tmp.cleanup()
    phase_new_route_times(torch, mk, dk, serving, Trainer, apply_cli_overrides, load_cfg,
                          synthetic_avmnist_arrays, np, report, l_served, dyna_bf16_served)
    l_tmp.cleanup()
    phase_mimic_times(torch, mk, gk, serving, Trainer, apply_cli_overrides, load_cfg, np, report)
    product_yardsticks(torch, report)

    card = card_line()
    report["card"] = card
    report["seconds"] = time.time() - t_start
    t = report["times_ms"]
    b1, by1 = report["bounds_ms"]["K1f/encoder/B512/f32"]
    b2, by2 = report["bounds_ms"]["K2f/encoder/B512/f32"]
    b3, by3 = report["bounds_ms"]["K1b/encoder/B512"]
    b4, by4 = report["bounds_ms"]["K2b/encoder/B512"]
    b5, by5 = report["bounds_ms"]["K3f/encoder/B512"]
    b6, by6 = report["bounds_ms"]["K3b/encoder/B512"]
    b7, by7 = report["bounds_ms"]["K4f/B512"]
    b8, by8 = report["bounds_ms"]["K4b/B512"]
    b9, by9 = report["bounds_ms"]["K1b_bf16/encoder/B512"]
    b10, by10 = report["bounds_ms"]["K2b_bf16/encoder/B512"]
    kernels = [
        {"name": "mixer_fwd (K1f, one MixerBlock, B=512 N=4 D=128 T=32 C=3072 f32, channel FF "
                 "on 3xTF32 tensor cores)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_fwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:213",
         "launches": report["main_path_launches"]["K1f"],
         "max_abs_err": report["errors"]["K1f/encoder/f32/erf"],
         "ms": t["K1f/encoder/B512/f32"], "plain_ms": t["K1f_plain/encoder/B512/f32"],
         "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "mixer_fwd (K2f, 4 MixerBlocks + LN, B=512 N=4 D=128 T=32 C=3072 f32, "
                 "channel FF on 3xTF32 tensor cores)",
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
        {"name": "gmlp_fwd (K3f, one gMLP block, B=512 N=49 D=128 F=768 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/gmlp.cu",
         "replaces": "m2mixer_tpu/ops/gmlp_kernel.py:134",
         "launches": report["gmlp_serving_launches"],
         "max_abs_err": report["errors"]["K3f/encoder/B512/rate0.0/erf"],
         "ms": t["K3f/encoder/B512"], "plain_ms": t["K3f_plain/encoder/B512"],
         "bound_ms": b5, "bound_by": by5, "library_ms": None},
        {"name": "gmlp_bwd (K3b, one gMLP block backward, B=512 N=49 D=128 F=768 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/gmlp.cu",
         "replaces": "m2mixer_tpu/ops/gmlp_kernel.py:167",
         "launches": report["gmlp_training_launches"]["K3b"],
         "max_abs_err": report["errors"]["K3b/encoder/B512/rate0.0/erf"],
         "ms": t["K3b/encoder/B512"], "plain_ms": t["K3b_plain/encoder/B512"],
         "bound_ms": b6, "bound_by": by6, "library_ms": None},
        {"name": "dyna_fwd (K4f, one DynaMixerOp, S=3584 L=7 C=256 H=8 R=2 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/dynamixer.cu",
         "replaces": "m2mixer_tpu/ops/dynamixer_kernel.py:130",
         "launches": report["dyna_serving_launches"],
         "max_abs_err": report["errors"]["K4f/B512/x1"],
         "ms": t["K4f/B512"], "plain_ms": t["K4f_plain/B512"],
         "bound_ms": b7, "bound_by": by7, "library_ms": None},
        {"name": "dyna_bwd (K4b, one DynaMixerOp backward, S=3584 L=7 C=256 H=8 R=2 f32)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/dynamixer.cu",
         "replaces": "m2mixer_tpu/ops/dynamixer_kernel.py:162",
         "launches": report["dyna_training_run"]["launches"]["K4b"],
         "max_abs_err": report["errors"]["K4b/B512/x1"],
         "ms": t["K4b/B512"], "plain_ms": t["K4b_plain/B512"],
         "bound_ms": b8, "bound_by": by8, "library_ms": None},
        {"name": "mixer_bwd bf16 (K1b, one MixerBlock backward, bf16 compute, B=512 N=4 D=128 "
                 "T=32 C=3072, dropout 0.5, channel products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:267",
         "launches": report["turbo_training_launches"]["K1b_bf16"],
         "max_abs_err": report["errors"]["K1b_bf16/encoder/B512/rate0.5/erf"],
         "ms": t["K1b_bf16/encoder/B512"], "plain_ms": t["K1b_bf16_plain/encoder/B512"],
         "bound_ms": b9, "bound_by": by9, "library_ms": None},
        {"name": "mixer_bwd bf16 (K2b, 4 MixerBlocks + LN backward, bf16 compute, B=512 N=4 "
                 "D=128 T=32 C=3072, dropout 0.5, channel products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:506",
         "launches": report["turbo_training_launches"]["K2b_bf16"],
         "max_abs_err": report["errors"]["K2b_bf16/encoderx4/g0/B512/rate0.5/erf"],
         "ms": t["K2b_bf16/encoder/B512"], "plain_ms": t["K2b_bf16_plain/encoder/B512"],
         "bound_ms": b10, "bound_by": by10, "library_ms": None},
    ]
    bd = report["bounds_ms"]
    dyna_run = report["dyna_bf16_training_run"]["launches"]
    l_runs = {k: v["launches"] for k, v in report["l_runs"].items()}
    lf = "L/fusion/B512/bf16"
    kernels += [
        {"name": "dyna_fwd bf16 (K4f, one DynaMixerOp in bf16 compute, S=3584 L=7 C=256 H=8 "
                 "R=2, its three products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/dynamixer.cu",
         "replaces": "m2mixer_tpu/ops/dynamixer_kernel.py:130",
         "launches": report["dyna_bf16_serving_launches"],
         "max_abs_err": report["errors"]["K4f_bf16/B512/x1"],
         "ms": t["K4f_bf16/B512"], "plain_ms": t["K4f_bf16_plain/B512"],
         "bound_ms": bd["K4f_bf16/B512"][0], "bound_by": bd["K4f_bf16/B512"][1],
         "library_ms": None},
        {"name": "dyna_bwd bf16 (K4b, one DynaMixerOp backward in bf16 compute, S=3584 L=7 "
                 "C=256 H=8 R=2, its eight products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/dynamixer.cu",
         "replaces": "m2mixer_tpu/ops/dynamixer_kernel.py:162",
         "launches": dyna_run["K4b_bf16"],
         "max_abs_err": report["errors"]["K4b_bf16/B512/x1"],
         "ms": t["K4b_bf16/B512"], "plain_ms": t["K4b_bf16_plain/B512"],
         "bound_ms": bd["K4b_bf16/B512"][0], "bound_by": bd["K4b_bf16/B512"][1],
         "library_ms": None},
        {"name": "mixer_fwd bf16 token pipeline (K1f, one MixerBlock, L fusion: B=512 N=80 "
                 "D=512 T=256 C=4096, channel and token products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_fwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:213",
         "launches": l_runs["per_block"]["K1f_token_ff"],
         "max_abs_err": report["errors"]["K1f/L/fusion/B512/bf16"],
         "ms": t[f"K1f/{lf}"], "plain_ms": t[f"K1f_plain/{lf}"],
         "bound_ms": bd[f"K1f/{lf}"][0], "bound_by": bd[f"K1f/{lf}"][1], "library_ms": None},
        {"name": "mixer_fwd bf16 token pipeline (K2f, 2 MixerBlocks + LN, L fusion: B=512 N=80 "
                 "D=512 T=256 C=4096, channel and token products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_fwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:421",
         "launches": l_runs["stacked"]["K2f_token_ff"],
         "max_abs_err": report["errors"]["K2f/L/fusion/B512/bf16"],
         "ms": t[f"K2f/{lf}"], "plain_ms": t[f"K2f_plain/{lf}"],
         "bound_ms": bd[f"K2f/{lf}"][0], "bound_by": bd[f"K2f/{lf}"][1], "library_ms": None},
        {"name": "mixer_bwd bf16 token pipeline (K1b, one MixerBlock backward, L fusion: B=512 "
                 "N=80 D=512 T=256 C=4096, dropout 0.5, channel products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:267",
         "launches": l_runs["per_block"]["K1b_token_ff"],
         "max_abs_err": report["errors"]["K1b/L/fusion/B512/bf16"],
         "ms": t[f"K1b/{lf}"], "plain_ms": t[f"K1b_plain/{lf}"],
         "bound_ms": bd[f"K1b/{lf}"][0], "bound_by": bd[f"K1b/{lf}"][1], "library_ms": None},
        {"name": "mixer_bwd bf16 token pipeline (K2b, 2 MixerBlocks + LN backward, L fusion: "
                 "B=512 N=80 D=512 T=256 C=4096, dropout 0.5, channel products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/mixer_bwd.cu",
         "replaces": "m2mixer_tpu/ops/mixer_kernel.py:506",
         "launches": l_runs["stacked"]["K2b_token_ff"],
         "max_abs_err": report["errors"]["K2b/L/fusion/B512/bf16"],
         "ms": t[f"K2b/{lf}"], "plain_ms": t[f"K2b_plain/{lf}"],
         "bound_ms": bd[f"K2b/{lf}"][0], "bound_by": bd[f"K2b/{lf}"][1], "library_ms": None},
    ]
    gf, gb = "K3f_bf16/encoder/B512", "K3b_bf16/encoder/B512"
    kernels += [
        {"name": "gmlp_fwd bf16 (K3f, one gMLP block in bf16 compute, B=512 N=49 D=128 F=768, "
                 "products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/gmlp.cu",
         "replaces": "m2mixer_tpu/ops/gmlp_kernel.py:134",
         "launches": report["gmlp_bf16_serving_launches"],
         "max_abs_err": report["errors"][f"{gf}/rate0.0"],
         "ms": t[gf], "plain_ms": t["K3f_bf16_plain/encoder/B512"],
         "bound_ms": bd[gf][0], "bound_by": bd[gf][1], "library_ms": None},
        {"name": "gmlp_bwd bf16 (K3b, one gMLP block backward in bf16 compute, B=512 N=49 "
                 "D=128 F=768, products on bf16 wgmma)",
         "route": "cuda", "source": "m2mixer_tpu_torch/ops/csrc/gmlp.cu",
         "replaces": "m2mixer_tpu/ops/gmlp_kernel.py:167",
         "launches": report["gmlp_bf16_training_launches"]["K3b_bf16"],
         "max_abs_err": report["errors"][f"{gb}/rate0.0"],
         "ms": t[gb], "plain_ms": t["K3b_bf16_plain/encoder/B512"],
         "bound_ms": bd[gb][0], "bound_by": bd[gb][1], "library_ms": None},
    ]
    kernels += slice_kernels(report)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, "kernels": kernels}, f, indent=2)
    print(f"[16/16] done in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
