"""Config system: YAML + attribute-access dicts + dotted CLI overrides.

The port's own copy of ``m2mixer_tpu/config/__init__.py`` (the port imports
nothing from the JAX package): ``load``, attribute access, ``.get``,
``deep_update``, ``from_cli`` (dotted overrides) and ``todict``, with the
same semantics, so the shipped YAML configs and run.py-style dotted
overrides resolve identically in both packages.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import yaml

__all__ = [
    "DictConfig",
    "ListConfig",
    "load",
    "loads",
    "save",
    "from_cli",
    "deep_update",
    "todict",
    "merge",
    "find_new_keys",
    "warn_unknown_overrides",
    "apply_cli_overrides",
]


class DictConfig(dict):
    """A dict with attribute access and recursive wrapping of nested values."""

    def __init__(self, data: Mapping | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- wrapping ---------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, DictConfig):
            return value
        if isinstance(value, Mapping):
            return DictConfig(value)
        if isinstance(value, list):
            return [DictConfig._wrap(v) for v in value]
        if isinstance(value, tuple):
            return tuple(DictConfig._wrap(v) for v in value)
        return value

    # -- mapping protocol --------------------------------------------------
    def __setitem__(self, key, value):
        super().__setitem__(key, DictConfig._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "DictConfig":
        return DictConfig({k: v for k, v in self.items()})

    def __deepcopy__(self, memo):
        import copy

        return DictConfig({k: copy.deepcopy(v, memo) for k, v in self.items()})


# OmegaConf-style alias; lists are plain lists here.
ListConfig = list


def load(path: str) -> DictConfig:
    """Load a YAML file into a DictConfig (anchors/aliases supported)."""
    with open(path) as f:
        data = yaml.safe_load(f)
    return DictConfig(data or {})


def loads(text: str) -> DictConfig:
    return DictConfig(yaml.safe_load(text) or {})


def save(cfg: Mapping, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(todict(cfg), f, sort_keys=False)


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value with YAML typing rules ('1e-3' -> float)."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_cli_overrides(cfg: "DictConfig", raw_args: Iterable[str],
                        warn: bool = True) -> "DictConfig":
    """The CLI override contract, in one place (run.py, serving export,
    significance runner, checkpoint import all share it): parse run.py-style
    dotted tokens (``--`` prefixes stripped; note ``.replace('--', '')``
    also mangles values containing ``--`` — kept for parity across every
    entry point), warn on keys that would be newly created (typo guard;
    ``warn=False`` for repeat merges of already-guarded tokens), and
    deep-merge the known sections into ``cfg`` in place. Returns the parsed
    override tree."""
    overrides = from_cli([u.replace("--", "") for u in raw_args])
    if warn:
        warn_unknown_overrides(cfg, overrides)
    for section in ("model", "train", "dataset"):
        if section in overrides:
            deep_update(cfg[section], overrides[section])
    return overrides


def from_cli(args: Iterable[str]) -> DictConfig:
    """Build a nested config from ``a.b.c=value`` strings.

    Mirrors ``OmegaConf.from_cli`` so wandb-sweep-style dotted overrides
    keep working.
    """
    out = DictConfig()
    for arg in args:
        arg = arg.strip()
        if not arg:
            continue
        if "=" not in arg:
            key, raw = arg, "true"
        else:
            key, raw = arg.split("=", 1)
        key = key.lstrip("-")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], DictConfig):
                node[p] = DictConfig()
            node = node[p]
        node[parts[-1]] = _parse_value(raw)
    return out


def deep_update(mapping: dict, *updating_mappings: Mapping) -> dict:
    """Recursively merge ``updating_mappings`` into ``mapping`` *in place*.

    Mutates its first argument so callers holding sub-config references
    (train_cfg/model_cfg) observe the merged values.
    """
    for updating in updating_mappings:
        for k, v in updating.items():
            if k in mapping and isinstance(mapping[k], Mapping) and isinstance(v, Mapping):
                deep_update(mapping[k], v)
            else:
                mapping[k] = v
    return mapping


def merge(*configs: Mapping) -> DictConfig:
    """Return a new DictConfig that is the deep merge of ``configs``."""
    out = DictConfig()
    for cfg in configs:
        deep_update(out, cfg)
    return out


def find_new_keys(base: Mapping, overrides: Mapping, prefix: str = "") -> list:
    """Dotted paths in ``overrides`` that do NOT exist in ``base``.

    A dotted CLI override with a typo (``train.optimzer.lr=...``) silently
    creates a fresh dead key under OmegaConf-style merge semantics — the run
    proceeds with the default value and a sweep quietly optimizes nothing.
    This walks the override tree against the loaded config so the CLI can
    surface such keys. Returns leaf-most new paths only (once a subtree is
    new, its children aren't separately listed)."""
    new = []
    for k, v in overrides.items():
        path = f"{prefix}{k}"
        if not (isinstance(base, Mapping) and k in base):
            new.append(path)
        elif isinstance(v, Mapping) and isinstance(base[k], Mapping):
            new.extend(find_new_keys(base[k], v, path + "."))
    return new


def warn_unknown_overrides(cfg: Mapping, overrides: Mapping) -> list:
    """Print a stderr warning for override paths that create NEW config keys
    (legit for switching on optional features; fatal-in-effect when it's a
    typo), with did-you-mean suggestions from the sibling key names.
    Returns the list of new dotted paths (for tests/callers)."""
    import difflib
    import sys

    new_paths = find_new_keys(cfg, overrides)
    for path in new_paths:
        parts = path.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node[p] if isinstance(node, Mapping) and p in node else None
            if node is None:
                break
        hint = ""
        if isinstance(node, Mapping):
            close = difflib.get_close_matches(parts[-1], list(node), n=2)
            if close:
                hint = f" (did you mean: {', '.join(close)}?)"
        print(f"[config] override creates NEW key '{path}'{hint} — "
              "fine for optional features, a silent no-op if it's a typo",
              file=sys.stderr)
    return new_paths


def todict(obj: Any) -> Any:
    """Recursively convert DictConfigs into plain dicts/lists."""
    if isinstance(obj, Mapping):
        return {k: todict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [todict(v) for v in obj]
    return obj
