"""Weights across the two packages: the JAX parameter tree <-> the port's
``state_dict``.

The JAX task's variables are nested dicts (``{"params": {"encoders_0":
{"block_0": {"token_mix": {"fc1": {"linear": {"kernel": ...}}}}}}}``) of
numpy arrays. The port's modules carry the same submodule names, so a leaf
maps by rule:

- ``encoders_i`` / ``heads_i`` / ``block_i`` -> ``encoders.i`` / ``heads.i``
  / ``blocks.i``;
- ``.../linear/kernel (in, out)`` -> ``....weight (out, in)``: the one
  transpose between the layouts happens here, and only here;
- ``.../linear/bias`` -> ``....bias``; ``.../LayerNorm_0/{scale,bias}`` ->
  ``....{weight,bias}``;
- the gMLP family's Dense layers are bare flax ``nn.Dense`` (``proj_1``,
  ``proj_2``, ``sgu/proj``, ``patch_embedding``), whose leaves sit directly
  under the layer: ``.../proj_1/kernel`` -> ``....proj_1.weight``
  (transposed), ``.../proj_1/bias`` -> ``....proj_1.bias``;
- the kernel blocks' leaves (``stack/b0_w1``, ``block_0/w3``, ...) keep the
  JAX kernels' layout and pass through unchanged; the kernel gMLP blocks'
  (``block_0/w_in``, ...) sit one level deeper in the port, under the
  ``gmlp`` stack the plain modules have (``gmlp.blocks.0.w_in``);
- the GRU's cell (``.../GRUCell_0/{ir,iz,in,hr,hz,hn}/{kernel,bias}``, bare
  flax ``nn.Dense`` layers with a bias on both sides) -> ``torch.nn.GRU``'s
  stacked ``....gru.{weight,bias}_{ih,hh}_l0``, the gates' rows in the order
  (r, z, n), each kernel transposed: three JAX leaves a stacked tensor's
  thirds, each shape-checked.

Both directions raise on a leaf left over, a leaf missing, or a shape
mismatch, leaf by leaf.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params", "flatten_tree", "unflatten_tree", "load_npz"]

_SEQ = re.compile(r"(encoders|heads|block)_(\d+)")
_PORT_SEQ = {"encoders": "encoders", "heads": "heads", "block": "blocks"}
_JAX_SEQ = {v: k for k, v in _PORT_SEQ.items()}
_BARE_DENSE = ("proj_1", "proj_2", "patch_embedding")  # the gMLP family's nn.Dense layers
# the kernel gMLP block's leaves (ops/gmlp_kernel.py GmlpBlockParams)
_GMLP_FLAT = ("ln_scale", "ln_bias", "w_in", "b_in", "sgu_ln_scale", "sgu_ln_bias", "sgu_w",
              "sgu_b", "w_out", "b_out")


_GRU_CELL = "GRUCell_0"
_GRU_SIDES = (("ih", ("ir", "iz", "in")), ("hh", ("hr", "hz", "hn")))
_GRU_PORT = re.compile(r"(.*)\.gru\.(weight|bias)_(ih|hh)_l0")


def _take_gru(flat):
    """Split the GRU cells' leaves off a flat JAX tree: (the rest, {port
    name: stacked array}, what a cell lacks or has left over)."""
    rest, cells = {}, {}
    for path, leaf in flat.items():
        if _GRU_CELL in path and len(path) - path.index(_GRU_CELL) == 3:
            i = path.index(_GRU_CELL)
            cells.setdefault(path[:i], {})[path[i + 1:]] = np.asarray(leaf, np.float32)
        else:
            rest[path] = leaf
    stacked, faults = {}, []
    for prefix, cell in cells.items():
        port = _port_name(prefix + ("gru",))[0]  # the module's torch.nn.GRU
        for side, gates in _GRU_SIDES:
            for leaf, name in (("kernel", "weight"), ("bias", "bias")):
                keys = [(g, leaf) for g in gates]
                lost = [k for k in keys if k not in cell]
                faults += ["/".join(prefix + (_GRU_CELL,) + k) + " (missing)" for k in lost]
                if lost:
                    continue
                parts = [cell.pop(k) for k in keys]
                if any(p.shape != parts[0].shape for p in parts):
                    faults.append(f"{'/'.join(prefix)}/{_GRU_CELL}/*/{leaf}: gate shapes "
                                  f"{[p.shape for p in parts]}")
                    continue
                stacked[f"{port}.{name}_{side}_l0"] = np.concatenate(
                    [p.T if leaf == "kernel" else p for p in parts], axis=0)
        faults += ["/".join(prefix + (_GRU_CELL,) + k) for k in cell]
    return rest, stacked, faults


def _is_bare_dense(mods) -> bool:
    return bool(mods) and (mods[-1] in _BARE_DENSE or list(mods[-2:]) == ["sgu", "proj"])


def flatten_tree(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dicts -> ``{path tuple: leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_tree(flat: Dict[Tuple[str, ...], object]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _port_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """JAX leaf path (under ``params``) -> (port name, transpose?)."""
    *mods, leaf = path
    wrapper = mods[-1] if mods else None
    parts = []
    for k in mods:
        m = _SEQ.fullmatch(k)
        if m:
            parts += [_PORT_SEQ[m[1]], m[2]]
        elif k not in ("linear", "LayerNorm_0"):
            parts.append(k)
    if wrapper == "linear" or (_is_bare_dense(mods) and leaf in ("kernel", "bias")):
        leaf, transpose = {"kernel": ("weight", True), "bias": ("bias", False)}[leaf]
    elif wrapper == "LayerNorm_0":
        leaf, transpose = {"scale": "weight", "bias": "bias"}[leaf], False
    else:
        transpose = False
    if leaf in _GMLP_FLAT and parts[-2:-1] == ["blocks"] and "gmlp" not in parts:
        parts.insert(len(parts) - 2, "gmlp")  # before blocks.j
    return ".".join(parts + [leaf]), transpose


def from_jax_params(variables, network: torch.nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The JAX task's variables (``{"params": tree}`` or the bare tree) ->
    a ``state_dict`` for ``network``, float32 tensors on the CPU."""
    tree = variables["params"] if "params" in variables else variables
    target = network.state_dict()
    out, leftover, mismatched = OrderedDict(), [], []
    flat, gru, faults = _take_gru(flatten_tree(tree))
    leftover += faults
    for name, a in gru.items():
        if name not in target:
            leftover.append(name)
            continue
        if tuple(a.shape) != tuple(target[name].shape):
            mismatched.append(f"{name}: {tuple(a.shape)} vs {tuple(target[name].shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    for path, leaf in flat.items():
        try:
            name, transpose = _port_name(path)
        except KeyError:
            leftover.append("/".join(path))
            continue
        if name not in target:
            leftover.append("/".join(path))
            continue
        a = np.asarray(leaf, np.float32)
        t = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
        if tuple(t.shape) != tuple(target[name].shape):
            mismatched.append(f"{'/'.join(path)} -> {name}: {tuple(t.shape)} "
                              f"vs {tuple(target[name].shape)}")
        out[name] = t
    missing = sorted(set(target) - set(out))
    if leftover or missing or mismatched:
        raise ValueError(f"JAX params do not match the port's network: "
                         f"leftover={leftover} missing={missing} mismatched={mismatched}")
    return OrderedDict((k, out[k]) for k in target)


def to_jax_params(state_dict) -> dict:
    """A port ``state_dict`` -> ``{"params": tree}`` of float32 numpy arrays
    in the JAX package's layout (the inverse of ``from_jax_params``)."""
    flat = {}
    for name, t in state_dict.items():
        gru = _GRU_PORT.fullmatch(name)
        if gru:  # the stacked GRU tensor -> its three gates' JAX leaves
            prefix = tuple(_jax_path(gru[1].split(".")) + [_GRU_CELL])
            leaf = "kernel" if gru[2] == "weight" else "bias"
            a = t.detach().cpu().float().numpy()
            if a.shape[0] % 3:
                raise ValueError(f"{name}: {a.shape[0]} rows, not three gates' worth")
            for g, part in zip(dict(_GRU_SIDES)[gru[3]], np.split(a, 3, axis=0)):
                flat[prefix + (g, leaf)] = np.ascontiguousarray(part.T if leaf == "kernel"
                                                                else part)
            continue
        parts = name.split(".")
        *mods, leaf = parts
        path = _jax_path(mods)
        a = t.detach().cpu().float().numpy()
        weight = state_dict.get(".".join(mods + ["weight"]))
        if leaf in ("weight", "bias") and weight is not None and weight.dim() == 2:
            path += ([] if _is_bare_dense(mods) else ["linear"]) + \
                ["kernel" if leaf == "weight" else "bias"]
            a = a.T if leaf == "weight" else a
        elif leaf in ("weight", "bias") and weight is not None and weight.dim() == 1:
            path += ["LayerNorm_0", "scale" if leaf == "weight" else "bias"]
        else:
            if leaf in _GMLP_FLAT and "gmlp" in path:
                path.remove("gmlp")
            path.append(leaf)
        key = tuple(path)
        if key in flat:
            raise ValueError(f"two port leaves map to the JAX leaf {'/'.join(key)}")
        flat[key] = np.ascontiguousarray(a)
    return {"params": unflatten_tree(flat)}


def _jax_path(mods) -> list:
    """Port module names -> the JAX path (``blocks.0`` -> ``block_0``)."""
    path, i = [], 0
    while i < len(mods):
        if mods[i] in _JAX_SEQ and i + 1 < len(mods) and mods[i + 1].isdigit():
            path.append(f"{_JAX_SEQ[mods[i]]}_{mods[i + 1]}")
            i += 2
        else:
            path.append(mods[i])
            i += 1
    return path


def load_npz(path: str, network: torch.nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """A weights npz -> a ``state_dict`` for ``network``: the port's
    ``state_dict`` (what training and ``export_serving`` write), or a JAX
    parameter tree with '/'-joined leaf paths."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if any("/" in k for k in arrays):
        tree = unflatten_tree({tuple(k.split("/")): v for k, v in arrays.items()})
        return from_jax_params(tree, network)
    return OrderedDict((k, torch.from_numpy(v)) for k, v in arrays.items())
