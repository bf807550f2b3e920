"""Data modules and their registry: ``get_data_module(dataset.type)``.

Only the ported modules resolve; a name the JAX package knows but the port
does not yet raise ``NotImplementedError("not yet ported: <name>")``.
"""

from __future__ import annotations

from .avmnist import AVMnistDataModule, synthetic_avmnist_arrays
from .base import ArrayDataModule

__all__ = ["AVMnistDataModule", "ArrayDataModule", "get_data_module", "synthetic_avmnist_arrays"]

DATA_MODULES = {"AVMnistDataModule": AVMnistDataModule}


def get_data_module(data_type: str):
    try:
        return DATA_MODULES[data_type]
    except KeyError:
        raise NotImplementedError(f"not yet ported: {data_type}") from None
