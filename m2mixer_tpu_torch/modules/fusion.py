"""Fusion operators (the slice's part of ``m2mixer_tpu/modules/fusion.py``).

Every fusion implements the construction-time shape-inference protocol
``get_output_shape(*shapes, dim=...)`` that sizes the fusion mixer.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ConcatFusion", "ConcatDynaFusion", "MaxFusion"]


def _dim_requires_int(args):
    if not isinstance(args[0], int):
        raise ValueError("The dim argument is only used if the first argument is an int.")


class ConcatFusion:
    """Concatenate along ``dim`` (two ``(B, 4, D)`` encodings -> ``(B, 8, D)``
    at dim 1)."""

    def __init__(self, dim=1, **kwargs):
        self.dim = dim

    def __call__(self, *args):
        return torch.cat(args, dim=self.dim)

    def get_output_shape(self, *args, dim=None):
        if dim is not None:
            _dim_requires_int(args)
            if dim == self.dim:
                return sum(args)
            return args[0]
        shape = list(args[0])
        for arg in args[1:]:
            shape[self.dim] += arg[self.dim]
        return tuple(shape)


class ConcatDynaFusion:
    """Concatenate on axis 1, then duplicate on axis 2: two ``(B, 7, 7, C)``
    grids -> a square ``(B, 14, 14, C)`` grid for the DynaMixer fusion path."""

    def __init__(self, dim=1, **kwargs):
        self.dim = dim

    def __call__(self, *args):
        a = torch.cat(args, dim=1)
        return torch.cat([a, a], dim=2)

    def get_output_shape(self, *args, dim=None):
        if dim is not None:
            _dim_requires_int(args)
            if dim == self.dim:
                return (int(math.sqrt(args[0])) * 2) ** 2
            return args[0]
        shape = list(args[0])
        for arg in args[1:]:
            shape[1] += arg[1]
            shape[2] += arg[2]
        return tuple(shape)


class MaxFusion:
    """Elementwise maximum of two modalities."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, *args):
        return torch.maximum(*args)

    @staticmethod
    def get_output_shape(*args, dim=None):
        if dim is not None:
            _dim_requires_int(args)
        if args[0] != args[1]:
            raise ValueError("Input shapes must be equal")
        return args[0]
