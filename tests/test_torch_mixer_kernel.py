"""The port's fused-mixer wrappers against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run only on the card; tests/test_torch_cuda_kernels.py holds them
there). The JAX side runs the Pallas kernels as its own tests do: interpret
mode on the CPU. Inputs come from one numpy RandomState and go to both.

Tolerances: float32 <= 5e-5 absolute (same math, different summation
order and erf: the TPU kernel's A&S erf is within 1.5e-7 of exact erf).
bf16 rounds the residual stream at the same points on both sides, but a
float32 sum taken in another order can land a value on the other side of a
bf16 rounding boundary (one bf16 ulp, 2**-8 relative), which later blocks
carry: bf16 cases hold the max error to 2e-2 of the output's max magnitude.
That limit alone cannot tell a skipped rounding point, and XLA on the CPU
may skip them (``--xla_allow_excess_precision``, on by default): with it on,
40-80% of the JAX kernel's bf16 outputs differ from the port's. So one test
runs the JAX kernels in a subprocess with that flag off and asserts that at
most 10% of the outputs differ at all.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.ops import mixer_kernel as jk
from m2mixer_tpu_torch.ops import mixer_kernel as tk
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(N=4, D=32, T=16, C=64)
B_ENC = dict(N=4, D=128, T=32, C=3072)
B_FUSION = dict(N=8, D=128, T=32, C=3078)
F32_ATOL = 5e-5
BF16_REL = 2e-2
BF16_MISMATCH = 0.10


@contextlib.contextmanager
def jax_gelu(approximate: bool):
    prev = set_gelu_approximate(approximate)
    try:
        yield
    finally:
        set_gelu_approximate(prev)


def block_arrays(rng, N, D, T, C):
    """One block's 12 parameters (numpy, JAX layout), torch-default scales
    with LN params away from the identity so the casts matter."""
    u = lambda fan_in, *shape: rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
    arrs = [1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), u(N, N, T), u(N, T), u(T, T, N),
            u(T, N), 1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), u(D, D, C), u(D, C),
            u(C, C, D), u(C, D)]
    return [a.astype(np.float32) for a in arrs]


def make_case(seed, B, K, N, D, T, C):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, D).astype(np.float32)
    blocks = [block_arrays(rng, N, D, T, C) for _ in range(K)]
    ln = [(1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)]
    return x, blocks, ln


def jax_blocks(blocks):
    return [jk.MixerBlockParams(*map(jnp.asarray, b)) for b in blocks]


def torch_blocks(blocks):
    return [tk.MixerBlockParams(*map(torch.from_numpy, b)) for b in blocks]


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_close(got, want, dtype_name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.max(np.abs(got - want)))
    if dtype_name == "f32":
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_REL * float(np.max(np.abs(want))), err


def run_both(fn, x, blocks, ln, dtype, approx, group_size=0):
    jd, td = DTYPES[dtype]
    xt = torch.from_numpy(x)
    with jax_gelu(approx):
        if fn == "block":
            want = jk.fused_mixer_block(jnp.asarray(x), jax_blocks(blocks)[0], compute_dtype=jd)
            got = tk.fused_mixer_block(xt, torch_blocks(blocks)[0], compute_dtype=td,
                                       approximate_gelu=approx)
        elif fn == "reference":
            want = jk.mixer_block_reference(jnp.asarray(x), jax_blocks(blocks)[0],
                                            compute_dtype=jd)
            got = tk.mixer_block_reference(xt, torch_blocks(blocks)[0], compute_dtype=td,
                                           approximate_gelu=approx)
        elif fn == "stack":
            jl, tl = list(map(jnp.asarray, ln)), list(map(torch.from_numpy, ln))
            want = jk.fused_mixer_stack(jnp.asarray(x),
                                        jk.stack_flat_params(jax_blocks(blocks), *jl),
                                        compute_dtype=jd)
            got = tk.fused_mixer_stack(xt, tk.stack_flat_params(torch_blocks(blocks), *tl),
                                       compute_dtype=td, approximate_gelu=approx)
        else:  # grouped
            jl, tl = list(map(jnp.asarray, ln)), list(map(torch.from_numpy, ln))
            want = jk.fused_mixer_stack_grouped(jnp.asarray(x), jax_blocks(blocks), *jl,
                                                compute_dtype=jd, group_size=group_size)
            got = tk.fused_mixer_stack_grouped(xt, torch_blocks(blocks), *tl,
                                               compute_dtype=td, group_size=group_size,
                                               approximate_gelu=approx)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["block", "reference", "stack"])
def test_small_geometry_matches_jax(fn, dtype, gelu):
    x, blocks, ln = make_case(1, 8, 2, **SMALL)
    got, want = run_both(fn, x, blocks, ln, dtype, gelu == "tanh")
    assert_close(got, want, dtype)


@pytest.mark.parametrize("group_size", [0, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_stack_matches_jax(dtype, group_size):
    x, blocks, ln = make_case(2, 8, 4, **SMALL)
    got, want = run_both("grouped", x, blocks, ln, dtype, False, group_size)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geom", ["encoder", "fusion"])
def test_b_geometry_stack_matches_jax(geom, dtype):
    """Full B widths at batch 2: N=4/C=3072 (encoders), N=8/C=3078 (fusion)."""
    x, blocks, ln = make_case(3, 2, 2, **(B_ENC if geom == "encoder" else B_FUSION))
    got, want = run_both("grouped", x, blocks, ln, dtype, False, group_size=1)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("geom", ["encoder", "fusion"])
def test_b_geometry_block_matches_jax(geom):
    x, blocks, ln = make_case(4, 2, 1, **(B_ENC if geom == "encoder" else B_FUSION))
    got, want = run_both("block", x, blocks, ln, "f32", True)
    assert_close(got, want, "f32")


def test_group_seeds_fold_like_jax(monkeypatch):
    """Group g of a grouped stack gets seed + 7919*g, as in the JAX package."""
    x, blocks, ln = make_case(5, 2, 5, **SMALL)
    seen = []
    real = tk.fused_mixer_stack

    def spy(x, flat, seed=None, *a, **k):
        seen.append((seed, len(flat)))
        return real(x, flat, seed, *a, **k)

    monkeypatch.setattr(tk, "fused_mixer_stack", spy)
    tk.fused_mixer_stack_grouped(torch.from_numpy(x), torch_blocks(blocks),
                                 *map(torch.from_numpy, ln), seed=11, group_size=2)
    assert seen == [(11, 24), (11 + 7919, 24), (11 + 2 * 7919, 14)]


def test_dropout_raises_until_training_slice():
    """The training slice runs dropout, and the bf16 slice the bf16 backward;
    what they do not take still raises: a rate outside [0, 1), and a compute
    dtype other than float32 or bfloat16 (on every route)."""
    x, blocks, ln = make_case(6, 2, 1, **SMALL)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tk.fused_mixer_block(torch.from_numpy(x), torch_blocks(blocks)[0], dropout_rate=1.0)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tk.fused_mixer_stack(torch.from_numpy(x),
                             tk.stack_flat_params(torch_blocks(blocks), *map(torch.from_numpy, ln)),
                             dropout_rate=-0.5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.fused_mixer_stack_bwd(torch.from_numpy(x), torch.from_numpy(x),
                                 tk.stack_flat_params(torch_blocks(blocks),
                                                      *map(torch.from_numpy, ln)),
                                 compute_dtype=torch.float16)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, blocks, ln = make_case(7, 3, 2, **SMALL)
    before = (tk.fused_mixer_block.launches, tk.fused_mixer_stack.launches)
    xt, tb = torch.from_numpy(x), torch_blocks(blocks)
    flat = tk.stack_flat_params(tb, *map(torch.from_numpy, ln))
    torch.testing.assert_close(tk.fused_mixer_stack(xt, flat),
                               tk.mixer_stack_reference(xt, flat), rtol=0, atol=0)
    torch.testing.assert_close(tk.fused_mixer_block(xt, tb[0]),
                               tk.mixer_block_reference(xt, tb[0]), rtol=0, atol=0)
    assert (tk.fused_mixer_block.launches, tk.fused_mixer_stack.launches) == before


def test_other_devices_raise():
    x = torch.zeros(2, 4, 32, device="meta")
    _, blocks, _ = make_case(8, 2, 1, **SMALL)
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_mixer_block(x, torch_blocks(blocks)[0])


@pytest.mark.parametrize("shape", [(64, 32), (80, 128), (8, 3078), (128, 3072), (3072,)])
def test_castable_rule_matches_jax(shape):
    a = np.zeros(shape, np.float32)
    assert tk._castable(torch.from_numpy(a)) == jk._castable(jnp.asarray(a))


def test_bf16_kernel_modules_store_channel_weights_narrow(monkeypatch):
    """The JAX layout: a bf16 kernel-backed mixer keeps all twelve parameters
    of every block in float32 (as ``m2mixer_tpu/modules/pallas_blocks.py``
    does), and the kernels are fed bf16 copies of the castable channel
    weights w3/w4, cast on each call (``_cast_params``). It answers as a
    module holding w3/w4 in bf16 did: the bf16 forward reads the same bf16
    values either way."""
    from m2mixer_tpu_torch.modules.pallas_blocks import PallasStackedFusionMixer

    def make(dtype):
        return PallasStackedFusionMixer(128, 4, 2, 16, 128, dtype=dtype,
                                        generator=torch.Generator().manual_seed(0))

    narrow, wide = make(torch.bfloat16), make(None)
    assert all(p.dtype == torch.float32 for p in narrow.parameters())
    narrow.load_state_dict(wide.state_dict())
    read = []
    real = tk._block_math

    def spy(x, p, *a, **k):
        read.append((p.w3.dtype, p.w4.dtype, p.w1.dtype))
        return real(x, p, *a, **k)

    monkeypatch.setattr(tk, "_block_math", spy)
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 4, 128).astype(np.float32))
    s = wide.stack
    narrow_w = [tk.MixerBlockParams(*(getattr(s, f"b{i}_{f}").to(torch.bfloat16)
                                      if f in ("w3", "w4") else getattr(s, f"b{i}_{f}")
                                      for f in tk.MixerBlockParams._fields))
                for i in range(2)]
    with torch.no_grad():
        got = narrow(x)
        assert read == [(torch.bfloat16, torch.bfloat16, torch.float32)] * 2
        want = tk.fused_mixer_stack_grouped(x, narrow_w, s.ln_out_scale, s.ln_out_bias,
                                            compute_dtype=torch.bfloat16)
        assert torch.equal(got, want)


_JAX_NO_EXCESS_PRECISION = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from m2mixer_tpu.ops import mixer_kernel as jk
z = dict(np.load(sys.argv[1]))
out = {}
for case in sorted({k.split("/")[0] for k in z}):
    x = jnp.asarray(z[case + "/x"])
    k = int(z[case + "/k"])
    blocks = [jk.MixerBlockParams(*(jnp.asarray(z[f"{case}/p{i}_{j}"]) for j in range(12)))
              for i in range(k)]
    if k == 1:
        y = jk.fused_mixer_block(x, blocks[0], compute_dtype=jnp.bfloat16)
    else:
        flat = jk.stack_flat_params(blocks, jnp.asarray(z[case + "/s"]), jnp.asarray(z[case + "/b"]))
        y = jk.fused_mixer_stack(x, flat, compute_dtype=jnp.bfloat16)
    out[case] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""


def test_bf16_cast_points_match_jax_bit_for_bit(tmp_path):
    """With XLA keeping no excess precision, the JAX kernels (interpret mode)
    and the port's wrappers round at the same points: at most 10% of the
    bf16 outputs differ at all (a sum on the other side of a rounding
    boundary). With XLA's default, 40-80% differ."""
    import os
    import subprocess
    import sys

    cases = {"block_small": (8, 1, SMALL), "stack_small": (8, 3, SMALL),
             "block_encoder": (2, 1, B_ENC), "stack_fusion": (2, 2, B_FUSION)}
    arrays, inputs = {}, {}
    for i, (case, (b, k, geom)) in enumerate(sorted(cases.items())):
        x, blocks, ln = make_case(40 + i, b, k, **geom)
        inputs[case] = (x, blocks, ln)
        arrays.update({f"{case}/x": x, f"{case}/k": np.int64(k), f"{case}/s": ln[0],
                       f"{case}/b": ln[1]})
        arrays.update({f"{case}/p{bi}_{j}": a for bi, blk in enumerate(blocks)
                       for j, a in enumerate(blk)})
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX_NO_EXCESS_PRECISION, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env, cwd=repo, timeout=300)
    with np.load(tmp_path / "out.npz") as z:
        want = {k: z[k] for k in z.files}
    for case, (x, blocks, ln) in inputs.items():
        xt, tb = torch.from_numpy(x), torch_blocks(blocks)
        if len(tb) == 1:
            got = tk.fused_mixer_block(xt, tb[0], compute_dtype=torch.bfloat16)
        else:
            flat = tk.stack_flat_params(tb, *map(torch.from_numpy, ln))
            got = tk.fused_mixer_stack(xt, flat, compute_dtype=torch.bfloat16)
        got = got.numpy()
        assert_close(got, want[case], "bf16")
        share = float(np.mean(got != want[case]))
        assert share <= BF16_MISMATCH, (case, share)
