"""Experiment runner of the port (counterpart of ``run.py``), same CLI surface:

    python -m m2mixer_tpu_torch.run -c cfg/avmnist/avmnist_m2-mixer_B.yml -n my_run \\
        [-m train|test] [-p WEIGHTS.npz] [--device cpu] [--disable-wandb] \\
        [model.dropout=0.2 train.optimizer.lr=1e-3 ...]

Unknown arguments are dotted config overrides. ``-m train`` fits and then
tests the best weights; ``-m test`` tests the weights given with ``-p`` (an
npz of the port's ``state_dict``, as training writes to
``<run>/checkpoints/{best,last}.npz``, or of a JAX parameter tree). The run
goes on the GPU; without one it exits with a message unless ``--device cpu``
is given (the kernels' plain PyTorch versions). ``--disable-wandb`` is
accepted and ignored: the port logs to ``metrics.jsonl`` only.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .config import apply_cli_overrides, load
from .datasets import get_data_module
from .models import get_model, resolve_device
from .training.trainer import Trainer
from .utils.weights import load_npz


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", type=str, required=True)
    parser.add_argument("-n", "--name", type=str)
    parser.add_argument("-p", "--ckpt", type=str, help="weights npz for -m test")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (the kernels' plain versions)")
    parser.add_argument("--disable-wandb", action="store_true", default=False)
    return parser.parse_known_args(argv)


def build(args, unknown):
    if not os.path.isfile(args.cfg):
        raise SystemExit(f"error: config file not found: {args.cfg}")
    cfg = load(args.cfg)
    apply_cli_overrides(cfg, unknown)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"run: {e}") from None
    train_cfg, dataset_cfg, model_cfg = cfg.train, cfg.dataset, cfg.model
    task = get_model(model_cfg.type)(model_cfg, train_cfg.optimizer, device=device,
                                     seed=int(train_cfg.get("seed", 0)))
    datamodule = get_data_module(dataset_cfg.type)(**dataset_cfg.params)
    trainer = Trainer(train_cfg, name=args.name or "run", full_cfg=cfg)
    return cfg, task, datamodule, trainer


def main(argv: Optional[Sequence[str]] = None):
    args, unknown = parse_args(argv)
    if args.mode not in ("train", "test"):
        raise SystemExit(f"run: not yet ported: -m {args.mode}")
    cfg, task, datamodule, trainer = build(args, unknown)
    if args.mode == "train":
        trainer.fit(task, datamodule)
        trainer.test(task, datamodule, ckpt="best")
    else:
        if args.ckpt:
            task.network.load_state_dict(load_npz(args.ckpt, task.network), strict=True)
        trainer.test(task, datamodule, ckpt=None)
    trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
