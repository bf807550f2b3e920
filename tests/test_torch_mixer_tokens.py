"""The port's mixer kernels above 32 tokens against the JAX package's, on the CPU.

The JAX kernels take any token count; the port's CUDA kernels run their
token FF in registers up to 32 tokens and as products on the tensor cores
above (``csrc/token_ff.cuh``, held to the plain versions on the card by
``tests/test_torch_cuda_kernels.py``). On the CPU the wrappers run the plain
versions at any token count, so here they are held to JAX's
``fused_mixer_block`` / ``fused_mixer_stack`` (Pallas, interpret mode, as the
JAX package's own tests run them) at N = 33 and 40, narrow widths:

- forward, float32 within 5e-5 absolute and bf16 within 2e-2 of the output's
  max magnitude (``tests/test_torch_mixer_kernel.py``'s tolerances and
  reasons), erf GELU, dropout 0;
- float32 gradients through the ``autograd.Function``s within 5e-5 absolute
  (``tests/test_torch_mixer_grad.py``'s); the bf16 gradients at these token
  counts are in ``tests/test_torch_mixer_bf16_grad.py``;
- at dropout 0.5 the JAX masks cannot be reproduced (``ROADMAP.md`` §3), so
  the plain route is held to the mask hash (``dropout_mask``): the forward
  equals the block math with ``block_masks``' four masks bit for bit, and a
  hidden unit of the token FF that mask 0 drops in every column gives its
  row of W2 and its b1 exactly zero gradient.

And the bf16 kernel math where the residual stream is large: on trained L
weights it reaches |x| ~ 200 (a bf16 ulp of 1), and the kernel artifact's
served logits part from the float32 network's faster than the plain bf16
modules' do (``ROADMAP.md`` §3). Four blocks at 80 tokens with |x| above 200
run through the port's plain bf16 version (what the kernels are held to on
the card) and through JAX's ``_block_math`` (XLA keeping no excess
precision, in a subprocess): the two agree (DRIFT_AGREE) and both depart
from float32 by the same amount, block after block, so the drift is the
cast scheme's and not the port's.
"""

import numpy as np
import pytest
import torch

from m2mixer_tpu.ops import mixer_kernel as jk
from m2mixer_tpu_torch.ops import mixer_kernel as tk
from test_torch_mixer_grad import assert_grads_close, jax_grads, torch_grads
from test_torch_mixer_kernel import assert_close, make_case, run_both, torch_blocks
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

GEOMS = {"n33": dict(N=33, D=8, T=12, C=16), "n40": dict(N=40, D=16, T=12, C=16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["block", "stack"])
@pytest.mark.parametrize("shape", sorted(GEOMS))
def test_forward_above_32_tokens_matches_jax(shape, fn, dtype):
    x, blocks, ln = make_case(3, 3, 2, **GEOMS[shape])
    got, want = run_both(fn, x, blocks, ln, dtype, False)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("fn", ["block", "stack"])
@pytest.mark.parametrize("shape", sorted(GEOMS))
def test_grads_above_32_tokens_match_jax(shape, fn):
    x, blocks, ln = make_case(4, 3, 2, **GEOMS[shape])
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    if fn == "block":
        flat = blocks[0]
        jf = lambda x, p: jk.fused_mixer_block(x, jk.MixerBlockParams(*p))
        tf = lambda x, p: tk.fused_mixer_block(x, tk.MixerBlockParams(*p))
    else:
        flat = [a for b in blocks for a in b] + ln
        jf = lambda x, p: jk.fused_mixer_stack(x, p)
        tf = lambda x, p: tk.fused_mixer_stack(x, p)
    assert_grads_close(torch_grads(tf, x, g, flat), jax_grads(jf, x, g, flat, False))


def test_dropout_above_32_tokens_follows_the_mask_hash():
    N, D, T, C = 40, 4, 64, 16
    x, blocks, ln = make_case(6, 1, 2, N=N, D=D, T=T, C=C)
    tb = [tk.MixerBlockParams(*(torch.from_numpy(a).requires_grad_() for a in b))
          for b in blocks]
    xt = torch.from_numpy(x)
    out = tk.fused_mixer_stack(xt, tk.stack_flat_params(tb), seed=11, dropout_rate=0.5,
                               final_ln=False)
    with torch.no_grad():
        y = xt
        for k, p in enumerate(tb):
            y = tk._block_math(y, p, torch.float32, False,
                               tk.block_masks(11, k, 1, N, D, T, C, 0.5))
    torch.testing.assert_close(out.detach(), y, rtol=0, atol=0)
    out.sum().backward()
    m0 = tk.block_masks(11, 0, 1, N, D, T, C, 0.5)[0]  # (B*D, T)
    dead = (m0 == 0).all(dim=0)  # hidden units dropped in every (sample, channel) column
    assert 0 < int(dead.sum()) < T
    assert torch.all(tb[0].w2.grad[dead] == 0) and torch.all(tb[0].b1.grad[dead] == 0)
    assert torch.all(tb[0].w2.grad[~dead].abs().sum(dim=1) > 0)


_JAX_BLOCK_CHAIN = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.ops import mixer_kernel as jk
z = dict(np.load(sys.argv[1]))
blocks = [jk.MixerBlockParams(*(jnp.asarray(z[f"p{i}_{j}"]) for j in range(12)))
          for i in range(int(z["k"]))]
out = {}
for name, cd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    step = jax.jit(lambda x, p: jk._block_math(x, p, None, cd))
    y = jnp.asarray(z["x"])
    for k, p in enumerate(blocks):
        y = step(y, p)
        out[f"{name}/{k}"] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""
DRIFT_AGREE = 0.1  # port-vs-JAX bf16 distance, and drift difference, as shares of JAX's drift


def test_bf16_kernel_math_drifts_from_float32_as_jax_does(tmp_path):
    import os
    import subprocess
    import sys

    N, D, T, C, K = 80, 64, 32, 128, 4
    x, blocks, _ = make_case(7, 2, K, N=N, D=D, T=T, C=C)
    rng = np.random.RandomState(8)
    x = (20 * x + 200 * (rng.rand(1, 1, D) > 0.9) * np.sign(rng.randn(1, 1, D))).astype(
        np.float32)  # a tenth of the channels carry a large residual, as trained L weights do
    assert np.abs(x).max() >= 200
    arrays = {"x": x, "k": np.int64(K)}
    arrays.update({f"p{i}_{j}": a for i, blk in enumerate(blocks) for j, a in enumerate(blk)})
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX_BLOCK_CHAIN, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env, cwd=repo, timeout=300)
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))
    drifts = []
    with np.load(tmp_path / "out.npz") as z:
        y32 = ybf = torch.from_numpy(x)
        for k, p in enumerate(torch_blocks(blocks)):
            y32 = tk.mixer_block_reference(y32, p)
            ybf = tk.mixer_block_reference(ybf, p, compute_dtype=torch.bfloat16)
            j32, jbf = z[f"f32/{k}"], z[f"bf16/{k}"]
            assert np.abs(j32).max() >= 200 and rel(y32.numpy(), j32) <= 1e-5
            port, jax_ = rel(ybf.numpy(), y32.numpy()), rel(jbf, j32)
            assert rel(ybf.numpy(), jbf) <= DRIFT_AGREE * jax_, (k, rel(ybf.numpy(), jbf), jax_)
            assert abs(port - jax_) <= DRIFT_AGREE * jax_, (k, port, jax_)
            drifts.append(jax_)
    # a bf16 ulp at 256 is 2 (0.8% of the stream): the drift grows block by block
    assert drifts[0] > 1e-3 and drifts[-1] > drifts[0], drifts

