"""The served slice as a whole, and the serving mechanics, on the CPU.

The JAX ``AVMnistMixerMultiLoss`` serve function (plain flax blocks, and
the fused Pallas blocks of ``to_pallas_serving`` in interpret mode) against
the port's served outputs (plain modules, and the kernel-backed blocks of
``to_torch_kernel_serving``, whose wrappers take their plain versions on
CPU tensors), with the same weights carried by ``from_jax_params``.

Tolerances: float32 logits within 1e-4 absolute (8 blocks of float32 math
in another summation order; measured ~1e-6). ``model.precision: bf16``
within 5e-2 of the logits' max magnitude: flax and torch round bf16 at
different points outside the kernels (Dense outputs, bias adds).
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import load as jload
from m2mixer_tpu.config import loads as jloads
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.serving import _serve_fn, to_pallas_serving
from m2mixer_tpu_torch.config import load, loads
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.serving import (_build_task, export_serving, load_serving, main,
                                       pick_bucket, serve_fn, to_torch_kernel_serving,
                                       validate_features)
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
B_CFG = str(REPO / "cfg" / "avmnist" / "avmnist_m2-mixer_B.yml")
NARROW = """
train: {seed: 0, optimizer: {lr: 1.0e-3}}
model:
  type: AVMnistMixerMultiLoss
  dropout: 0.5
  modalities:
    classification: {num_classes: 10, classifier: StandardClassifier, input_shape: [16, 8, 32]}
    image: {block_type: MLPMixer, in_channels: 1, hidden_dim: 32, patch_size: 14,
            image_size: [28, 28], token_dim: 16, channel_dim: 64, num_mixers: 2}
    audio: {block_type: MLPMixer, in_channels: 1, hidden_dim: 32, patch_size: 56,
            image_size: [112, 112], token_dim: 16, channel_dim: 64, num_mixers: 2}
    multimodal: {block_type: FusionMixer, fusion_function: ConcatFusion, hidden_dim: 32,
                 token_dim: 16, channel_dim: 64, num_mixers: 2}
"""


def batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 1, 28, 28).astype(np.float32),
            "audio": rng.rand(n, 1, 112, 112).astype(np.float32)}


@contextlib.contextmanager
def restore_jax_gelu():
    prev = set_gelu_approximate(False)
    set_gelu_approximate(prev)
    try:
        yield
    finally:
        set_gelu_approximate(prev)


def jax_outputs(jcfg, params, feats, kernel: bool):
    """The JAX serve function's outputs (plain or Pallas-kernel blocks)."""
    with restore_jax_gelu():
        task = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
        if kernel:
            task, params = to_pallas_serving(jcfg, params, feats)
        out = _serve_fn(task)(params, feats)
        return [np.asarray(out["logits"], np.float32)] + \
            [np.asarray(b, np.float32) for b in out["branch_logits"]]


def jax_params(jcfg, seed=1):
    with restore_jax_gelu():
        task = jget_model(jcfg.model.type)(jcfg.model, jcfg.train.optimizer)
        return jax.tree.map(np.asarray, task.init_params(jax.random.PRNGKey(seed), batch(2)))


def port_outputs(cfg, params, feats, kernel):
    """The port's served outputs; ``kernel``: False (plain modules), True or
    "stacked" (stack kernel blocks), "per_block" (block kernel blocks)."""
    task = _build_task(cfg, device="cpu")
    task.network.load_state_dict(from_jax_params(params, task.network))
    if kernel:
        task, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu",
                                          per_block=kernel == "per_block")
    out = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})
    return [out["logits"].float().numpy()] + [b.float().numpy() for b in out["branch_logits"]]


def assert_outputs_close(got, want, bf16=False):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.max(np.abs(g - w)))
        bound = 5e-2 * float(np.max(np.abs(w))) if bf16 else 1e-4
        assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def narrow_params():
    return jax_params(jloads(NARROW))


@pytest.fixture(scope="module")
def narrow_jax_outputs(narrow_params):
    """JAX outputs per (config text, stacked kernels?), computed once."""
    cache = {}

    def get(text, feats, stacked):
        if (text, stacked) not in cache:
            cache[text, stacked] = jax_outputs(jloads(text), narrow_params, feats, stacked)
        return cache[text, stacked]

    return get


@pytest.mark.parametrize("variant", ["f32-erf", "f32-tanh", "bf16-erf"])
@pytest.mark.parametrize("kernel", [False, "stacked", "per_block"],
                         ids=["plain", "stacked", "per_block"])
def test_narrow_slice_matches_jax(narrow_params, narrow_jax_outputs, kernel, variant):
    """JAX's kernel flavor is to_pallas_serving's stacked one; the port's
    per-block flavor is held against the JAX plain forward (same function)."""
    prec, gelu = variant.split("-")
    extra = (f"\n  approximate_gelu: {gelu == 'tanh'}"
             + ("\n  precision: bf16" if prec == "bf16" else ""))
    text = NARROW.replace("  dropout: 0.5", "  dropout: 0.5" + extra)
    feats = batch(5, seed=2)
    assert_outputs_close(port_outputs(loads(text), narrow_params, feats, kernel),
                         narrow_jax_outputs(text, feats, kernel == "stacked"),
                         bf16=prec == "bf16")


@pytest.fixture(scope="module")
def b_case():
    """Full-B weights from the port's seeded init, carried to the JAX layout,
    and JAX's served outputs with its plain flax blocks."""
    sd = _build_task(load(B_CFG), device="cpu", seed=3).network.state_dict()
    jcfg, params, feats = jload(B_CFG), to_jax_params(sd), batch(2, seed=4)
    return params, feats, jax_outputs(jcfg, params, feats, False)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_full_b_config_matches_jax_at_batch_2(b_case, kernel):
    """The port's plain modules and its stack kernel blocks against JAX's
    plain forward of the same function (JAX's own Pallas flavor of it is held
    to this port flavor at narrow width in test_narrow_slice_matches_jax)."""
    params, feats, want = b_case
    assert_outputs_close(port_outputs(load(B_CFG), params, feats, kernel), want)


def test_kernel_task_swaps_block_types():
    cfg = loads(NARROW)
    task = _build_task(cfg, device="cpu")
    ktask, _ = to_torch_kernel_serving(cfg, task.network.state_dict(), device="cpu")
    assert type(ktask.network.encoders[0]).__name__ == "PallasStackedMLPMixer"
    assert type(ktask.network.fusion_mixer).__name__ == "PallasStackedFusionMixer"
    assert cfg.model.modalities.image.block_type == "MLPMixer"  # caller's cfg untouched


def test_kernel_serving_rejects_unconvertible():
    cfg = loads(NARROW.replace("block_type: MLPMixer", "block_type: PallasMLPMixer")
                .replace("block_type: FusionMixer", "block_type: PallasFusionMixer"))
    with pytest.raises(ValueError, match="no convertible blocks"):
        to_torch_kernel_serving(cfg, {}, device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = loads(NARROW)
    task = _build_task(cfg, device="cpu")
    out = tmp_path_factory.mktemp("art")
    export_serving(task, cfg, str(out), buckets=(1, 4))
    return task, str(out)


def direct(task, feats):
    out = serve_fn(task)({k: torch.from_numpy(v) for k, v in feats.items()})
    return out["logits"].numpy(), [b.numpy() for b in out["branch_logits"]]


@pytest.mark.parametrize("n", [1, 3, 4, 11], ids=["exact", "padded", "top", "chunked"])
def test_buckets_pad_slice_and_chunk_like_a_direct_forward(artifact, n):
    task, out = artifact
    model = load_serving(out, device="cpu")
    feats = batch(n, seed=n)
    got = model.predict(feats)
    logits, branches = direct(task, feats)
    assert got["logits"].shape == (n, 10)
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-5, atol=1e-5)
    for g, w in zip(got["branch_logits"], branches):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,buckets,want", [(1, (1, 8, 32), 1), (5, (1, 8, 32), 8),
                                            (32, (32, 1, 8), 32), (600, (1, 512), 512)])
def test_pick_bucket(n, buckets, want):
    assert pick_bucket(n, buckets) == want


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing=\\['audio'\\]"), ("extra", "extra=\\['text'\\]"),
    ("shape", "trailing shape"), ("sizes", "inconsistent batch sizes"), ("empty", "empty batch")])
def test_validate_features_errors(artifact, fault, match):
    meta = load_serving(artifact[1], device="cpu").meta
    feats = batch(3)
    if fault == "missing":
        del feats["audio"]
    elif fault == "extra":
        feats["text"] = np.zeros((3, 4), np.float32)
    elif fault == "shape":
        feats["image"] = np.zeros((3, 1, 28, 27), np.float32)
    elif fault == "sizes":
        feats["image"] = feats["image"][:2]
    else:
        feats = {k: v[:0] for k, v in feats.items()}
    with pytest.raises(ValueError, match=match):
        validate_features(feats, meta)


def test_artifact_metadata(artifact):
    meta = load_serving(artifact[1], device="cpu").meta
    assert meta["format"] == "torch" and meta["block_flavor"] == "plain"
    assert meta["features"] == {"image": [1, 28, 28], "audio": [1, 112, 112]}
    assert meta["buckets"] == [1, 4]
    assert meta["config"]["model"]["type"] == "AVMnistMixerMultiLoss"


def test_load_serving_without_gpu_raises(artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the GPU is the default there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving(artifact[1])


def test_unported_task_and_options_raise():
    with pytest.raises(NotImplementedError, match="not yet ported: MMIMDBMixerMultiLoss"):
        get_model("MMIMDBMixerMultiLoss")
    cfg = loads(NARROW.replace("  dropout: 0.5", "  dropout: 0.5\n  qat: int8"))
    with pytest.raises(NotImplementedError, match="model.qat"):
        _build_task(cfg, device="cpu")


def test_cli_export_pallas_then_predict(narrow_params, tmp_path, capsys):
    """export --pallas from a JAX parameter tree ('/'-joined npz), then the
    predict CLI: the artifact serves the JAX model's logits."""
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(NARROW)
    jcfg, params = jloads(NARROW), narrow_params
    np.savez(tmp_path / "w.npz", **{"/".join(k): v for k, v in
                                    flatten_tree(params["params"]).items()})
    art = tmp_path / "art"
    main(["export", "-c", str(cfg_path), "-p", str(tmp_path / "w.npz"), "-o", str(art),
          "--pallas", "--buckets", "1,4", "--device", "cpu", "model.dropout=0.0"])
    meta = json.loads((art / "serving.json").read_text())
    assert meta["block_flavor"] == "kernel"
    assert meta["config"]["model"]["modalities"]["image"]["block_type"] == "PallasStackedMLPMixer"
    assert meta["config"]["model"]["dropout"] == 0.0
    feats = batch(6, seed=7)
    np.savez(tmp_path / "in.npz", **feats, label=np.zeros(6))
    capsys.readouterr()
    main(["predict", "-d", str(art), "-i", str(tmp_path / "in.npz"),
          "-o", str(tmp_path / "out.npz"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 6
    got = np.load(tmp_path / "out.npz")
    want = jax_outputs(jcfg, params, feats, kernel=False)
    np.testing.assert_allclose(got["logits"], want[0], atol=1e-4)
    np.testing.assert_allclose(got["branch_logits_1"], want[2], atol=1e-4)


def test_cli_predict_rejects_bad_features(artifact, tmp_path):
    np.savez(tmp_path / "bad.npz", image=np.zeros((2, 1, 28, 28), np.float32))
    with pytest.raises(SystemExit, match="missing"):
        main(["predict", "-d", artifact[1], "-i", str(tmp_path / "bad.npz"),
              "-o", str(tmp_path / "o.npz"), "--device", "cpu"])


def test_cli_bench_needs_the_gpu(artifact):
    with pytest.raises(RuntimeError, match="GPU"):
        main(["bench", "-d", artifact[1], "--device", "cpu", "--iters", "1"])


def test_cli_without_gpu_and_without_device_fails_clearly(artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run([sys.executable, "-m", "m2mixer_tpu_torch.serving", "bench",
                           "-d", artifact[1]], capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
