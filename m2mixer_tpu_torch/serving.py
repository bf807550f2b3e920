"""Model export and serving for the port (counterpart of ``m2mixer_tpu/serving.py``).

- ``to_torch_kernel_serving``: re-lay a task's plain ``MLPMixer`` /
  ``FusionMixer`` stacks onto the kernel-backed ``PallasStackedMLPMixer`` /
  ``PallasStackedFusionMixer`` (the counterpart of ``to_pallas_serving``),
  or with ``per_block`` onto ``PallasMLPMixer`` / ``PallasFusionMixer``; and
  ``VisiongMLP`` / ``FusiongMLP`` onto ``PallasVisiongMLP`` /
  ``PallasFusiongMLP`` (one gMLP block kernel per block) either way. Other
  blocks stay plain, as in JAX (MIMIC's ``MLPMixerNoPatching`` time mixer,
  its ``MLP`` and ``GRU``). A ``PairedMLPMixer`` is un-paired into the two
  per-modality stacks first (``unpair_mlp_mixer_params``), as
  ``to_pallas_serving`` does.
- ``export_serving``: write an artifact directory: ``serving.json`` (features,
  dtypes, buckets, the resolved config, the block flavor) and the weights
  (``weights.npz``, the port's ``state_dict``). The JAX artifact ships a
  serialized program; this one carries no program: ``load_serving`` rebuilds
  the network from the stored config with the port's own code and loads the
  weights into it, strictly.
- ``load_serving`` -> ``ServedModel``: eval-mode inference with batch
  buckets: a request pads with zeros to the smallest bucket that holds it,
  outputs are sliced back, and requests above the top bucket run in
  top-bucket chunks.

Serving runs on the GPU. Without one, the caller asks for the CPU
explicitly (``device="cpu"``, ``--device cpu``), which runs the kernels'
plain PyTorch versions; otherwise loading raises.

CLI::

    python -m m2mixer_tpu_torch.serving export -c CFG [-p weights.npz] -o DIR [--pallas]
    python -m m2mixer_tpu_torch.serving predict -d DIR -i in.npz -o out.npz
    python -m m2mixer_tpu_torch.serving bench -d DIR [--batch 32] [--iters 200]
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import DictConfig, apply_cli_overrides, load, todict
from .models import get_model, resolve_device
from .modules.paired import unpair_mlp_mixer_params
from .utils.weights import from_jax_params, load_npz, to_jax_params

__all__ = ["export_serving", "load_serving", "ServedModel", "pick_bucket",
           "validate_features", "serve_fn", "to_torch_kernel_serving"]

_META = "serving.json"
_WEIGHTS = "weights.npz"
_DEFAULT_BUCKETS = (1, 8, 32, 128, 512)
_GMLP_KERNELS = {"VisiongMLP": "PallasVisiongMLP", "FusiongMLP": "PallasFusiongMLP"}
_KERNEL_BLOCKS = {"MLPMixer": "PallasStackedMLPMixer",
                  "FusionMixer": "PallasStackedFusionMixer", **_GMLP_KERNELS}
_PER_BLOCK_KERNELS = {"MLPMixer": "PallasMLPMixer", "FusionMixer": "PallasFusionMixer",
                      **_GMLP_KERNELS}


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (requests larger than the top bucket are split
    by the caller)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)


def validate_features(features: Dict[str, np.ndarray], meta: dict) -> None:
    """Request-shape contract: every artifact feature present (and nothing
    extra), per-sample shapes matching the export spec, one consistent
    non-zero batch size. Raises ValueError with the mismatch spelled out."""
    want = meta["features"]
    missing = sorted(set(want) - set(features))
    extra = sorted(set(features) - set(want))
    if missing or extra:
        raise ValueError(f"feature mismatch: missing={missing} extra={extra} "
                         f"(artifact expects {sorted(want)})")
    sizes = set()
    for k, shp in want.items():
        a = features[k]
        if tuple(a.shape[1:]) != tuple(shp):
            raise ValueError(f"feature {k!r}: trailing shape {a.shape[1:]} "
                             f"!= artifact spec {tuple(shp)}")
        sizes.add(int(a.shape[0]))
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes across features: {sizes}")
    if 0 in sizes:
        raise ValueError("empty batch")


def serve_fn(task):
    """Eval-mode forward: features dict of tensors -> {'logits', 'branch_logits'}."""

    def fn(features):
        with torch.inference_mode():
            out = task.network(**task.network_inputs(features))
        return {"logits": out["logits"], "branch_logits": tuple(out["branch_logits"])}

    return fn


def _block_flat(b: dict) -> dict:
    """One modular ``MixerBlock`` subtree (JAX layout) -> the 12 kernel
    parameters (``MixerBlockParams`` names), same math."""
    ln = lambda m: m["LayerNorm_0"]
    fc = lambda m, i: m[f"fc{i}"]["linear"]
    return {
        "ln1_scale": ln(b["norm_token"])["scale"], "ln1_bias": ln(b["norm_token"])["bias"],
        "w1": fc(b["token_mix"], 1)["kernel"], "b1": fc(b["token_mix"], 1)["bias"],
        "w2": fc(b["token_mix"], 2)["kernel"], "b2": fc(b["token_mix"], 2)["bias"],
        "ln2_scale": ln(b["norm_channel"])["scale"], "ln2_bias": ln(b["norm_channel"])["bias"],
        "w3": fc(b["channel_mix"], 1)["kernel"], "b3": fc(b["channel_mix"], 1)["bias"],
        "w4": fc(b["channel_mix"], 2)["kernel"], "b4": fc(b["channel_mix"], 2)["bias"],
    }


def _stack_from_blocks(src: dict) -> dict:
    """Modular ``MLPMixer``/``FusionMixer`` subtree (``block_i`` + ``norm_out``,
    JAX layout) -> the flat ``stack`` dict of the stacked kernel blocks."""
    out, i = {}, 0
    while f"block_{i}" in src:
        out.update({f"b{i}_{k}": v for k, v in _block_flat(src[f"block_{i}"]).items()})
        i += 1
    out["ln_out_scale"] = src["norm_out"]["LayerNorm_0"]["scale"]
    out["ln_out_bias"] = src["norm_out"]["LayerNorm_0"]["bias"]
    return out


def _gmlp_block_flat(b: dict) -> dict:
    """One plain ``GatingMlpBlock`` subtree (JAX layout) -> the 10 kernel
    parameters (``GmlpBlockParams`` names), same math (JAX
    ``serving._gmlp_block_flat``)."""
    ln = lambda m: m["LayerNorm_0"]
    return {
        "ln_scale": ln(b["norm"])["scale"], "ln_bias": ln(b["norm"])["bias"],
        "w_in": b["proj_1"]["kernel"], "b_in": b["proj_1"]["bias"],
        "sgu_ln_scale": ln(b["sgu"]["norm"])["scale"],
        "sgu_ln_bias": ln(b["sgu"]["norm"])["bias"],
        "sgu_w": b["sgu"]["proj"]["kernel"], "sgu_b": b["sgu"]["proj"]["bias"],
        "w_out": b["proj_2"]["kernel"], "b_out": b["proj_2"]["bias"],
    }


def _build_task(cfg, device=None, seed: Optional[int] = None):
    if seed is None:
        seed = int(cfg.get("train", {}).get("seed", 0) or 0)
    return get_model(cfg.model.type)(cfg.model, cfg.get("train", {}).get("optimizer"),
                                     device=device, seed=seed)


def _submodule(network, key: str):
    """The network's module under a top-level JAX key (``encoders_1`` ->
    ``network.encoders[1]``; None where there is none)."""
    name, _, index = key.rpartition("_")
    if index.isdigit() and isinstance(getattr(network, name, None), torch.nn.ModuleList):
        return getattr(network, name)[int(index)]
    return getattr(network, key, None)


def to_torch_kernel_serving(cfg, state_dict, device=None, per_block: bool = False):
    """Swap ``MLPMixer`` -> ``PallasStackedMLPMixer`` and ``FusionMixer`` ->
    ``PallasStackedFusionMixer`` (one stack kernel per mixer) in a copy of
    ``cfg``, or with ``per_block`` -> ``PallasMLPMixer`` / ``PallasFusionMixer``
    (one block kernel per block); ``VisiongMLP`` / ``FusiongMLP`` ->
    ``PallasVisiongMLP`` / ``PallasFusiongMLP`` either way (one gMLP block
    kernel per block). Re-lay the plain modules' weights into the kernels'
    layout; paired encoders become per-modality ones. Returns
    ``(kernel_task, kernel_state_dict)`` with the weights loaded; the
    converted tree is checked leaf by leaf against the new network."""
    new_cfg = copy.deepcopy(cfg)
    mc = new_cfg.model.modalities
    kinds = _PER_BLOCK_KERNELS if per_block else _KERNEL_BLOCKS
    swapped = []
    for key in mc:
        bt = mc[key].get("block_type") if key != "classification" else None
        if bt in kinds:
            mc[key].block_type = kinds[bt]
            swapped.append(key)
    if not swapped:
        raise ValueError(
            "no convertible blocks: to_torch_kernel_serving fuses MLPMixer/FusionMixer/"
            f"VisiongMLP/FusiongMLP stacks; this config has "
            f"{sorted(set(mc[k].get('block_type') for k in mc if k != 'classification'))}")
    new_cfg.model.paired_encoders = False
    tree = to_jax_params(state_dict)["params"]
    if "paired_encoder" in tree:
        tree.update(zip(("encoders_0", "encoders_1"),
                        unpair_mlp_mixer_params(tree.pop("paired_encoder"))))
    task = _build_task(new_cfg, device=device)
    for k, sub in list(tree.items()):
        # only the swapped modules change layout: MIMIC's time mixer
        # (MLPMixerNoPatching) keeps its plain MixerBlocks, as in JAX
        if not type(_submodule(task.network, k)).__name__.startswith("Pallas"):
            continue
        if isinstance(sub, dict) and "norm_token" in sub.get("block_0", {}):
            if per_block:
                tree[k] = {kk: _block_flat(vv) if kk.startswith("block_") else vv
                           for kk, vv in sub.items()}
            else:
                newsub = {kk: vv for kk, vv in sub.items()
                          if not (kk.startswith("block_") or kk == "norm_out")}
                newsub["stack"] = _stack_from_blocks(sub)
                tree[k] = newsub
        elif isinstance(sub, dict) and "gmlp" in sub:
            newsub = {kk: vv for kk, vv in sub.items() if kk != "gmlp"}
            newsub.update({bk: _gmlp_block_flat(bv) for bk, bv in sub["gmlp"].items()})
            tree[k] = newsub
    converted = from_jax_params({"params": tree}, task.network)
    task.network.load_state_dict(converted)
    return task, converted


def export_serving(task, cfg, out_dir: str, buckets: Sequence[int] = _DEFAULT_BUCKETS,
                   extra_meta: Optional[dict] = None) -> str:
    """Write the serving artifact of ``task`` to ``out_dir``. The stored
    config is ``cfg`` with its model section taken from the task (so a
    kernel-backed task stores its swapped block types)."""
    spec = task.feature_spec()
    kernel = any(type(m).__name__.startswith("Pallas") for m in task.network.modules())
    os.makedirs(out_dir, exist_ok=True)
    weights = {k: v.detach().cpu().float().numpy() for k, v in task.network.state_dict().items()}
    np.savez(os.path.join(out_dir, _WEIGHTS), **weights)
    meta = {"format": "torch", "model_type": cfg.model.type,
            "features": {k: list(v[0]) for k, v in spec.items()},
            "dtypes": {k: v[1] for k, v in spec.items()},
            "buckets": sorted(int(b) for b in buckets),
            "block_flavor": "kernel" if kernel else "plain",
            "config": {**todict(cfg), "model": todict(task.model_cfg)},
            **(extra_meta or {})}
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


class ServedModel:
    """A loaded artifact: batch-bucketed eval-mode inference on ``device``."""

    def __init__(self, out_dir: str, device=None):
        self.out_dir = out_dir
        with open(os.path.join(out_dir, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != "torch":
            raise ValueError(f"{out_dir}: not a port artifact (format "
                             f"{self.meta.get('format')!r})")
        self.device = resolve_device(device)
        cfg = DictConfig(self.meta["config"])
        self.task = _build_task(cfg, device=self.device)
        with np.load(os.path.join(out_dir, _WEIGHTS), allow_pickle=False) as z:
            state = {k: torch.from_numpy(z[k]) for k in z.files}
        self.task.network.load_state_dict(state, strict=True)
        self.buckets = sorted(int(b) for b in self.meta["buckets"])
        self._fn = serve_fn(self.task)

    def forward_device(self, features: Dict[str, torch.Tensor]):
        """One forward over tensors already on the device (no padding)."""
        return self._fn(features)

    def _run_bucket(self, features: Dict[str, np.ndarray], n: int):
        bucket = pick_bucket(n, self.buckets)
        padded = {}
        for k, v in features.items():
            t = torch.as_tensor(np.asarray(v, dtype=self.meta["dtypes"][k]))
            if bucket > n:
                t = torch.cat([t, t.new_zeros((bucket - n, *t.shape[1:]))])
            padded[k] = t.to(self.device)
        out = self._fn(padded)
        return {"logits": out["logits"][:n].float().cpu().numpy(),
                "branch_logits": tuple(b[:n].float().cpu().numpy()
                                       for b in out["branch_logits"])}

    def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, object]:
        features = {k: v for k, v in features.items() if k != "label"}
        n = int(np.shape(next(iter(features.values())))[0])
        top = max(self.buckets)
        if n <= top:
            return self._run_bucket(features, n)
        chunks = [self._run_bucket({k: np.asarray(v)[i:i + top] for k, v in features.items()},
                                   min(top, n - i))
                  for i in range(0, n, top)]
        return {"logits": np.concatenate([c["logits"] for c in chunks]),
                "branch_logits": tuple(np.concatenate(parts) for parts in
                                       zip(*[c["branch_logits"] for c in chunks]))}


def load_serving(out_dir: str, device=None) -> ServedModel:
    return ServedModel(out_dir, device=device)


def _bench(model: ServedModel, batch: int, iters: int) -> dict:
    if model.device.type != "cuda":
        raise RuntimeError("bench measures CUDA-event latency on the GPU; this "
                           f"model is on {model.device}")
    rng = np.random.RandomState(0)
    feats = {k: rng.rand(batch, *shp).astype(model.meta["dtypes"][k])
             for k, shp in model.meta["features"].items()}
    model.predict(feats)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(feats)
    e2e = (time.perf_counter() - t0) / iters
    bucket = pick_bucket(batch, model.buckets)
    n = min(batch, bucket)
    dev = {k: torch.from_numpy(np.concatenate([v[:n], np.zeros((bucket - n, *v.shape[1:]),
                                                               v.dtype)])).to(model.device)
           for k, v in feats.items()}
    model.forward_device(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model.forward_device(dev)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return {"metric": "serving_latency_ms_device", "value": ms, "e2e_latency_ms": e2e * 1e3,
            "batch": n, "bucket": bucket, "device_throughput_samples_per_sec": n / ms * 1e3,
            "block_flavor": model.meta["block_flavor"],
            "device": torch.cuda.get_device_name(model.device)}


def main(argv: Optional[Sequence[str]] = None):
    """CLI: export an artifact, run offline inference, or bench latency."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export")
    ex.add_argument("-c", "--cfg", required=True)
    ex.add_argument("-p", "--weights", help="npz of weights (the port's state_dict, or a "
                                            "JAX parameter tree with '/'-joined paths); "
                                            "fresh init from train.seed if omitted")
    ex.add_argument("-o", "--out", required=True)
    ex.add_argument("--buckets", default="1,8,32,128,512")
    ex.add_argument("--pallas", action="store_true",
                    help="re-lay MLPMixer/FusionMixer stacks onto the CUDA stack kernel, "
                         "VisiongMLP/FusiongMLP onto the CUDA gMLP block kernel")
    pr = sub.add_parser("predict", help="offline batch inference over an npz of features")
    pr.add_argument("-d", "--dir", required=True)
    pr.add_argument("-i", "--input", required=True)
    pr.add_argument("-o", "--output", required=True)
    be = sub.add_parser("bench", help="CUDA-event latency of the served forward")
    be.add_argument("-d", "--dir", required=True)
    be.add_argument("--batch", type=int, default=32)
    be.add_argument("--iters", type=int, default=200)
    for p in (ex, pr, be):
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu (the kernels' plain versions)")
    args, unknown = ap.parse_known_args(argv)
    if unknown and args.cmd != "export":
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")

    if args.cmd == "export":
        cfg = load(args.cfg)
        if unknown:  # dotted config overrides, as run.py takes them
            apply_cli_overrides(cfg, unknown)
        task = _build_task(cfg, device=args.device)
        if args.weights:
            task.network.load_state_dict(load_npz(args.weights, task.network), strict=True)
        if args.pallas:
            task, _ = to_torch_kernel_serving(cfg, task.network.state_dict(),
                                              device=args.device)
        buckets = tuple(int(b) for b in args.buckets.split(","))
        out = export_serving(task, cfg, args.out, buckets=buckets)
        print(f"[serving] exported {'kernel' if args.pallas else 'plain'} artifact to {out}")
    elif args.cmd == "predict":
        model = load_serving(args.dir, device=args.device)
        with np.load(args.input, allow_pickle=False) as z:
            feats = {k: z[k] for k in z.files if k != "label"}
        try:
            validate_features(feats, model.meta)
        except ValueError as e:
            raise SystemExit(f"[serving] {args.input}: {e}")
        out = model.predict(feats)
        flat = {"logits": out["logits"]}
        flat.update({f"branch_logits_{i}": b for i, b in enumerate(out["branch_logits"])})
        np.savez(args.output, **flat)
        print(json.dumps({"metric": "predict_samples", "value": int(out["logits"].shape[0]),
                          "outputs": sorted(flat), "out": args.output}))
    else:
        model = load_serving(args.dir, device=args.device)
        print(json.dumps(_bench(model, args.batch, args.iters)))


if __name__ == "__main__":
    main()
