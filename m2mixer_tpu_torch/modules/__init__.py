"""Building blocks and the three string registries.

Counterpart of ``m2mixer_tpu/modules/__init__.py:41-77``: a config's
``block_type`` / ``fusion_function`` / ``classifier`` string resolves to a
class here, and the config kwargs are filtered to the ones its constructor
takes, so every component "accepts and ignores extras". Only what the port
has reached is registered; a name the JAX package knows but the port does
not yet raise ``NotImplementedError("not yet ported: <name>")``.
"""

from __future__ import annotations

import inspect

from .classification import StandardClassifier
from .dynamixer import DynaMixer, DynaMixerBlock, DynaMixerOp, FusionDynaMixer
from .fusion import ConcatDynaFusion, ConcatFusion, MaxFusion
from .gmlp import FusiongMLP, GatingMlpBlock, SpatialGatingUnit, VisiongMLP, gMLP
from .mixer import FeedForward, FusionMixer, MixerBlock, MLPMixer, MLPMixerNoPatching
from .mlp import MLP
from .pallas_blocks import (PallasFusiongMLP, PallasFusionMixer, PallasGatingMlpBlock,
                            PallasMixerBlock, PallasMLPMixer, PallasStackedFusionMixer,
                            PallasStackedMLPMixer, PallasVisiongMLP)
from .recurrent import GRU

__all__ = [
    "FeedForward", "MixerBlock", "MLPMixer", "FusionMixer", "ConcatFusion",
    "StandardClassifier", "PallasMixerBlock", "PallasMLPMixer", "PallasFusionMixer",
    "PallasStackedMLPMixer", "PallasStackedFusionMixer", "SpatialGatingUnit",
    "GatingMlpBlock", "gMLP", "VisiongMLP", "FusiongMLP", "PallasGatingMlpBlock",
    "PallasVisiongMLP", "PallasFusiongMLP", "DynaMixerOp", "DynaMixerBlock", "DynaMixer",
    "FusionDynaMixer", "ConcatDynaFusion", "MaxFusion", "MLPMixerNoPatching", "MLP", "GRU",
    "build_component", "get_block_by_name",
    "get_fusion_by_name", "get_classifier_by_name",
]

BLOCKS = {c.__name__: c for c in (MLPMixer, FusionMixer, PallasMLPMixer, PallasFusionMixer,
                                  PallasStackedMLPMixer, PallasStackedFusionMixer,
                                  SpatialGatingUnit, GatingMlpBlock, gMLP, VisiongMLP,
                                  FusiongMLP, PallasGatingMlpBlock, PallasVisiongMLP,
                                  PallasFusiongMLP, DynaMixer, FusionDynaMixer,
                                  MLPMixerNoPatching, MLP, GRU)}
FUSIONS = {c.__name__: c for c in (ConcatFusion, ConcatDynaFusion, MaxFusion)}
CLASSIFIERS = {"StandardClassifier": StandardClassifier}


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def build_component(cls, **kwargs):
    """Instantiate ``cls`` with only the kwargs its constructor accepts."""
    params = inspect.signature(cls.__init__).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return cls(**kwargs)
    return cls(**{k: _tuplify(v) for k, v in kwargs.items() if k in params and k != "self"})


def _resolve(registry: dict, name: str):
    try:
        return registry[name]
    except KeyError:
        raise NotImplementedError(f"not yet ported: {name}") from None


def get_block_by_name(**kwargs):
    """Resolve ``kwargs['block_type']`` to a block instance."""
    return build_component(_resolve(BLOCKS, kwargs["block_type"]), **kwargs)


def get_fusion_by_name(**kwargs):
    """Resolve ``kwargs['fusion_function']`` to a fusion instance."""
    return build_component(_resolve(FUSIONS, kwargs["fusion_function"]), **kwargs)


def get_classifier_by_name(**kwargs):
    """Resolve ``kwargs['classifier']`` to a classifier head instance."""
    return build_component(_resolve(CLASSIFIERS, kwargs["classifier"]), **kwargs)
