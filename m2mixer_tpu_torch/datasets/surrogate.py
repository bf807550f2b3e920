"""Surrogate datasets in the real files' layouts, made from a seed (the
port's copy of the part of ``m2mixer_tpu/datasets/surrogate.py`` that its
data modules read), so that a data module's file path runs end to end
without the download:

    python -m m2mixer_tpu_torch.datasets.surrogate mimic OUT [-n N] [--seed S]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

__all__ = ["gen_mimic", "generate", "FAMILIES"]


def gen_mimic(out: str, n: int = 2000, seed: int = 0) -> None:
    """``OUT/im.pk``: ``ep_tdata`` (N, 24, 12) time series,
    ``adm_features_all`` (N, 5) statics, ``adm_labels_all`` (N, 6) admission
    columns (the class is the first positive of columns 1-5, else 0),
    ``y_icd9`` (N, 20) binary task columns. Class signal: mean shifts in both
    modalities, and the task-1 column marks classes above 2."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 6, n)
    time = rng.randn(n, 24, 12) + (y[:, None, None] - 2.5) * 0.6
    static = rng.randn(n, 5) + (y[:, None] - 2.5) * 0.8
    adm = np.zeros((n, 6), np.int64)
    for i, c in enumerate(y):
        if c > 0:
            adm[i, c] = 1
    icd9 = rng.randint(0, 2, (n, 20))
    icd9[:, 1] = (y > 2).astype(np.int64)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "im.pk"), "wb") as f:
        pickle.dump({"ep_tdata": time, "adm_features_all": static,
                     "adm_labels_all": adm, "y_icd9": icd9}, f)
    print(f"[surrogate] mimic: {n} stays -> {out}/im.pk")


FAMILIES = {"mimic": gen_mimic}


def generate(family: str, out: str, n=None, seed: int = 0) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; the port has {sorted(FAMILIES)}")
    FAMILIES[family](out, seed=seed, **({} if n is None else {"n": n}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("out")
    ap.add_argument("-n", type=int, default=None, help="sample count (the family's default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    generate(args.family, args.out, n=args.n, seed=args.seed)


if __name__ == "__main__":
    main()
