"""The training engine (counterpart of ``m2mixer_tpu/training/trainer.py``).

- ``make_optimizer``: ``train.optimizer`` -> ``torch.optim.Adam`` (coupled L2:
  the decay joins the gradient before the moments, as the JAX chain
  ``add_decayed_weights -> scale_by_adam``) or ``AdamW`` (decoupled decay),
  with betas, eps and weight decay. Adam's update equals optax's
  ``scale_by_adam`` followed by ``scale_by_learning_rate``. With
  ``moment_dtype: bf16`` either one is ``optim.BF16MomentAdam`` (optax's
  ``mu_dtype=bfloat16``). Other optimizer types and options raise "not yet
  ported". ``train.prng_impl`` (JAX's PRNG implementation) has no counterpart:
  the port's randomness is torch generators, and the key is ignored.
- ``Trainer.train_step``: forward, the task's weighted loss, backward, and
  one optimizer step; when ``ctx['frozen']`` is set the frozen parameters'
  gradients are zero before the step and their values are restored after
  it, which is the JAX step's masking of both gradients and updates (their
  Adam moments still see the zero gradients, as in JAX).
- ``Trainer.fit``: the epoch loop: train epoch, validation epoch, the plateau
  LR on ``val_loss``, best-epoch summary, ``checkpoints/last.npz`` every
  epoch and ``checkpoints/best.npz`` when the monitored metric improves (the
  port's ``state_dict`` as npz, what ``serving export -p`` loads), early
  stopping. ``Trainer.test``: the test split with the best weights,
  ``test_preds.npz``.

Every epoch's numbers go to ``metrics.jsonl`` under the JAX trainer's keys
(``train_loss``, ``train_loss_<branch>``, ``train_<metric>``,
``train_samples_per_sec``, ``epoch``; ``val_*`` and ``lr``; ``test_*``;
``train_loss_step`` every ``log_interval_steps`` steps). The per-step losses
and predictions stay on the device during an epoch and are fetched once at
its end.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import todict
from ..utils.weights import load_npz
from .callbacks import EarlyStopping, ReduceLROnPlateau
from .loggers import ExperimentLogger
from .metrics import confusion_matrix
from .optim import BF16MomentAdam

__all__ = ["Trainer", "make_optimizer", "seed_everything"]

#: train-config keys of the JAX trainer that the port does not run yet
_UNPORTED_TRAIN = ("distill", "init_from", "auto_resume", "ema_eval", "log_mfu", "fsdp",
                   "sequence_parallel", "pool_chunk_mb", "distributed", "profile_dir",
                   "watch_gradients", "async_checkpointing")
_UNPORTED_OPTIMIZER = ("ema_decay", "grad_clip_norm", "grad_clip_value", "param_groups",
                       "schedule", "sam_rho", "pcgrad")


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_optimizer(optimizer_cfg, params):
    """``(optimizer, lr)`` from ``train.optimizer`` (``type`` adam or adamw)."""
    opt_type = str(optimizer_cfg.get("type", "adam") or "adam").lower()
    if opt_type not in ("adam", "adamw"):
        raise NotImplementedError(f"not yet ported: train.optimizer.type={opt_type}")
    for key in _UNPORTED_OPTIMIZER:
        if optimizer_cfg.get(key):
            raise NotImplementedError(f"not yet ported: train.optimizer.{key}")
    moment_dtype = optimizer_cfg.get("moment_dtype")
    if moment_dtype not in (None, "f32", "float32", "bf16", "bfloat16"):
        raise ValueError(f"train.optimizer.moment_dtype={moment_dtype!r}: expected bf16, "
                         "bfloat16, f32 or float32 (or unset for f32)")
    lr = float(optimizer_cfg.get("lr", 1e-3))
    betas = tuple(float(b) for b in optimizer_cfg.get("betas", (0.9, 0.999)))
    eps = float(optimizer_cfg.get("eps", 1e-8))
    wd = float(optimizer_cfg.get("weight_decay", 0.0))
    if moment_dtype in ("bf16", "bfloat16"):
        return BF16MomentAdam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd,
                              decoupled=opt_type == "adamw"), lr
    cls = torch.optim.Adam if opt_type == "adam" else torch.optim.AdamW
    return cls(params, lr=lr, betas=betas, eps=eps, weight_decay=wd), lr


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _state_npz(network, path: str) -> None:
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in network.state_dict().items()})


class Trainer:
    def __init__(self, train_cfg, name: str = "run", work_dir: Optional[str] = None,
                 full_cfg=None, early_stopping_patience: int = 30):
        for key in _UNPORTED_TRAIN:
            if train_cfg.get(key):
                raise NotImplementedError(f"not yet ported: train.{key}")
        if int(train_cfg.get("grad_accum_steps", 1) or 1) > 1:
            raise NotImplementedError("not yet ported: train.grad_accum_steps > 1")
        self.cfg = train_cfg
        self.name = name
        self.max_epochs = int(train_cfg.get("epochs", 1))
        self.monitor = train_cfg.get("monitor", "val_loss")
        self.monitor_mode = train_cfg.get("monitor_mode", "min")
        self.log_interval = int(train_cfg.get("log_interval_steps", 50))
        self.compute_train_metrics = bool(train_cfg.get("compute_train_metrics", True))
        self.seed = int(train_cfg.get("seed", 0))
        log_root = work_dir or train_cfg.get("tensorboard_path", "./logs")
        self.logger = ExperimentLogger(log_root, name,
                                       config=todict(full_cfg) if full_cfg else None)
        self.ckpt_dir = os.path.join(self.logger.log_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.early_stopping = EarlyStopping(monitor="val_loss", patience=early_stopping_patience,
                                            mode="min")
        self.optimizer = None
        self.plateau = None
        self.global_step = 0
        self.current_epoch = 0
        self.callback_metrics: Dict[str, float] = {}
        self.best_monitor: Optional[float] = None
        self.interrupted = False

    # ------------------------------------------------------------------ step
    def setup(self, task) -> None:
        """Optimizer and plateau LR for ``task`` (``fit`` calls it)."""
        self.optimizer, lr0 = make_optimizer(task.optimizer_cfg, task.network.parameters())
        self.plateau = ReduceLROnPlateau(lr0, patience=int(task.scheduler_patience))
        frozen = set(task.frozen_param_names())
        self._frozen = [p for n, p in task.network.named_parameters() if n in frozen]

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def train_step(self, task, batch, ctx):
        """One optimizer step on ``batch`` (tensors on the task's device);
        returns the detached loss and the task's aux dict."""
        net = task.network
        net.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = task.step(batch, ctx, train=True)
        loss.backward()
        for p in net.parameters():
            if p.grad is None:  # JAX differentiates every leaf: zero, not absent
                p.grad = torch.zeros_like(p)
        frozen = self._frozen if ctx["frozen"] > 0 else []
        kept = [p.detach().clone() for p in frozen]
        for p in frozen:
            p.grad.zero_()
        self.optimizer.step()
        with torch.no_grad():
            for p, v in zip(frozen, kept):
                p.copy_(v)
        return loss.detach(), aux

    def _to_device(self, task, batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(task.device, non_blocking=True)
                for k, v in batch.items()}

    # ----------------------------------------------------------------- epochs
    def _epoch_logs(self, prefix, losses, extra, preds, labels, scores):
        logs = {f"{prefix}_loss": float(torch.stack(losses).mean())}
        for k, vals in extra.items():
            logs[f"{prefix}_{k}"] = float(torch.stack(vals).mean())
        preds = torch.cat(preds).cpu().numpy() if preds else np.zeros((0,))
        labels = torch.cat(labels).cpu().numpy() if labels else np.zeros((0,))
        if scores is not None:
            for mname, metric in scores.items():
                metric.update(preds, labels)
                logs[f"{prefix}_{mname}"] = metric.compute()
                metric.reset()
        return logs, preds, labels

    def _run_train_epoch(self, task, datamodule, epoch, train_scores) -> None:
        ctx = task.make_ctx(epoch, "train")
        losses, preds, labels = [], [], []
        extra = {k: [] for k in task.epoch_log_keys()}
        t0, nsteps = time.time(), 0
        for batch in datamodule.train_batches():
            loss, aux = self.train_step(task, self._to_device(task, batch), ctx)
            self.global_step += 1
            nsteps += 1
            losses.append(loss)
            for k in extra:
                extra[k].append(aux["losses"][k.removeprefix("loss_")].detach())
            if self.compute_train_metrics and train_scores is not None:
                preds.append(aux["preds"])
                labels.append(aux["labels"])
            if self.log_interval and self.global_step % self.log_interval == 0:
                self.logger.log({"train_loss_step": float(loss)}, self.global_step)
        logs, _, _ = self._epoch_logs("train", losses, extra, preds, labels,
                                      train_scores if self.compute_train_metrics else None)
        logs["epoch"] = epoch
        logs["train_samples_per_sec"] = nsteps * datamodule.batch_size / (time.time() - t0)
        self.callback_metrics.update(logs)
        self.logger.log(logs, self.global_step)

    def _run_eval_epoch(self, task, batches, epoch, scores, prefix, collect_artifacts=False):
        ctx = task.make_ctx(epoch, prefix)
        task.network.eval()
        losses, preds, labels = [], [], []
        extra = {k: [] for k in task.epoch_log_keys()}
        keys = task.test_artifact_keys() if collect_artifacts else ()
        artifacts = {k: [] for k in keys}
        with torch.no_grad():
            for batch in batches:
                loss, aux = task.step(self._to_device(task, batch), ctx, train=False)
                losses.append(loss)
                for k in extra:
                    extra[k].append(aux["losses"][k.removeprefix("loss_")])
                preds.append(aux["preds"])
                labels.append(aux["labels"])
                for k in keys:
                    artifacts[k].append(aux[k])
        logs, p, lab = self._epoch_logs(prefix, losses, extra, preds, labels, scores)
        if getattr(task, "log_confusion_matrix", False) and p.size and p.ndim == 1:
            p_int, l_int = p.astype(np.int64), lab.astype(np.int64).reshape(-1)
            k = int(max(p_int.max(), l_int.max())) + 1
            np.save(os.path.join(self.logger.log_dir, f"confusion_matrix_{prefix}_{epoch}.npy"),
                    confusion_matrix(p_int, l_int, k))
        # bf16 logits (model.precision: bf16) are written as float32
        return logs, {k: _host(torch.cat(v)) for k, v in artifacts.items() if v}

    # -------------------------------------------------------------------- fit
    def fit(self, task, datamodule) -> None:
        datamodule.setup("fit")
        seed_everything(self.seed)
        self.setup(task)
        n = sum(p.numel() for p in task.network.parameters())
        self.logger.set_summary("total_parameters", n)
        self.logger.set_summary("trainable_parameters", n)
        print(f"[trainer] {self.name}: {n / 1e6:.3f}M parameters, device={task.device}")
        train_scores, val_scores, _ = task.setup_scores()
        train_start = time.time()
        try:
            for epoch in range(self.max_epochs):
                self.current_epoch = epoch
                task.on_train_epoch_start(self, epoch)
                self._run_train_epoch(task, datamodule, epoch, train_scores)
                task.on_train_epoch_end(self, epoch, dict(self.callback_metrics))
                logs, _ = self._run_eval_epoch(task, datamodule.val_batches(), epoch, val_scores,
                                               "val")
                task.on_validation_epoch_end(self, epoch, logs)
                new_lr = self.plateau.update(logs["val_loss"])
                self._set_lr(new_lr)
                logs["lr"] = new_lr
                best = self.logger.summary.get("best_val_loss")
                if best is None or logs["val_loss"] <= best:
                    self.logger.set_summary("best_val_loss", logs["val_loss"])
                    self.logger.set_summary("best_val_loss_epoch", epoch)
                    self.logger.set_summary("best_val_loss_time", time.time() - train_start)
                    for k, v in logs.items():
                        if k.startswith("val_") and k != "val_loss":
                            self.logger.set_summary(f"best_{k}", v)
                self.callback_metrics.update(logs)
                self.logger.log(logs, self.global_step)
                self._save_weights(task, logs)
                if self.early_stopping.update(logs):
                    print(f"[trainer] early stopping at epoch {epoch}")
                    break
        except KeyboardInterrupt:
            print("KeyboardInterrupt: proceeding to test with the current best model")
            self.interrupted = True

    def _save_weights(self, task, logs) -> None:
        _state_npz(task.network, self.last_path())
        value = logs.get(self.monitor)
        if value is None:
            return
        better = (self.best_monitor is None
                  or (value < self.best_monitor if self.monitor_mode == "min"
                      else value > self.best_monitor))
        if better:
            self.best_monitor = value
            _state_npz(task.network, self.best_path())

    def best_path(self) -> str:
        return os.path.join(self.ckpt_dir, "best.npz")

    def last_path(self) -> str:
        return os.path.join(self.ckpt_dir, "last.npz")

    # ------------------------------------------------------------------- test
    def test(self, task, datamodule, ckpt: Optional[str] = "best") -> Dict[str, float]:
        """Test split metrics with the ``best`` / ``last`` weights of this
        run, the weights at ``ckpt`` (an npz path), or the current ones
        (``None``)."""
        datamodule.setup("test")
        path = {"best": self.best_path(), "last": self.last_path()}.get(ckpt, ckpt)
        if path is not None and os.path.exists(path):
            task.network.load_state_dict(load_npz(path, task.network), strict=True)
        elif ckpt not in (None, "best", "last"):
            raise FileNotFoundError(f"no weights at {ckpt}")
        _, _, test_scores = task.setup_scores()
        t0 = time.time()
        logs, artifacts = self._run_eval_epoch(task, datamodule.test_batches(),
                                               self.current_epoch, test_scores, "test",
                                               collect_artifacts=True)
        self.logger.set_summary("test_time", time.time() - t0)
        if artifacts:
            out = os.path.join(self.ckpt_dir, "test_preds.npz")
            np.savez(out, **artifacts)
            print(f"[trainer] saved test predictions to {out}")
        self.callback_metrics.update(logs)
        self.logger.log(logs, self.global_step)
        print("[trainer] test:", {k: round(v, 5) for k, v in logs.items()})
        return logs
