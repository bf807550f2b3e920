"""Task base classes (counterpart of ``m2mixer_tpu/models/base.py``).

- ``TrainTask``: builds the network from the model config on a device, maps
  a batch to the network's inputs (``resolve_dtype`` as ``:62-70``), and
  holds the optimizer config the trainer reads, the task-level
  cross-entropy (label smoothing, focal), the network's dropout randomness,
  and the contract the trainer drives: ``make_ctx``, ``step``,
  ``setup_scores`` and the epoch hooks. Serving uses the network alone.
- ``MultiLossTask``: the multimodal multi-head recipe: loss weights with the
  x3 ``fixed_scaled`` rule or those of an estimator (``current_loss_weights``,
  ``:533-549``), the per-step context (``make_ctx``, ``:556-585``), muting
  (``resolve_mute_code``, ``:588-598``), the weighted sum of the branch
  losses and its per-branch terms (``_step_parts``, ``step_components``,
  ``:676-750``) with frozen -> fusion-only loss, the freeze prefixes
  (``:753-782``), the fusion-weight annealing hooks, and the loss-weight
  estimators' options and epoch hooks (``:462-513``, ``:801-836``):
  SoftAdapt (``modules/softadapt.py``, refit from the branches' validation
  losses), GradBlend (``modules/gradblend.py``, re-estimated by
  sub-training copies of the branches) and GradNorm
  (``modules/gradnorm.py``, from the branches' gradient norms).

The JAX step is a pure function of (params, batch, ctx, rngs); here the
network holds its parameters and ``step(batch, ctx, train)`` runs it. The
trainer masks frozen parameters' gradients and updates (``frozen_param_names``).
Mixup, CutMix and the calibration log raise "not yet ported".

A task owns its device. It defaults to ``cuda``; without a visible GPU the
caller has to ask for ``device="cpu"`` (the plain PyTorch versions of the
kernels), and anything else raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DictConfig
from ..modules import gradblend, gradnorm
from ..modules.common import DepthRNG, DropoutRNG, set_depth_rng, set_dropout_rng
from ..modules.losses import cross_entropy_loss
from ..modules.softadapt import LossWeightedSoftAdapt

__all__ = ["resolve_dtype", "resolve_device", "TrainTask", "MultiLossTask", "MUTE_NONE"]

MUTE_NONE = -1

#: model-config keys that change the forward or the step and are not ported yet
_UNPORTED_OPTIONS = ("qat", "prune", "lora")
_UNPORTED_MULTILOSS = ("mixup_alpha", "cutmix_alpha", "log_calibration")


def resolve_dtype(precision) -> Optional[torch.dtype]:
    """``model.precision`` -> compute dtype (parameters stay float32):
    'bf16'/'bfloat16' selects bfloat16; None/'f32' keeps float32 (None)."""
    if precision in ("bf16", "bfloat16"):
        return torch.bfloat16
    if precision in (None, "f32", "float32", "fp32"):
        return None
    raise ValueError(f"Unknown precision: {precision}")


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one, the caller must pass ``"cpu"``."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU. Pass "
                "device='cpu' (CLI: --device cpu) to run the plain PyTorch "
                "versions of the kernels on the CPU instead.")
        return torch.device("cuda")
    return torch.device(device)


class TrainTask(abc.ABC):
    """Builds ``self.network`` (eval mode, on ``device``) from the model
    config, and what the trainer needs beyond it.

    ``seed`` drives a CPU ``torch.Generator`` for the initial weights, so one
    seed gives the same weights on every device."""

    def __init__(self, model_cfg, optimizer_cfg=None, *, device=None, seed: int = 0):
        for key in _UNPORTED_OPTIONS:
            if model_cfg.get(key):
                raise NotImplementedError(f"not yet ported: model.{key}")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        generator = torch.Generator().manual_seed(int(seed))
        self.network = self.build_network(generator).to(self.device).eval()
        self.optimizer_cfg = DictConfig(optimizer_cfg or {})
        self.scheduler_patience = self.optimizer_cfg.pop("scheduler_patience", 5)
        self.loss_pos_weight = self.optimizer_cfg.pop("loss_pos_weight", None)
        self.log_confusion_matrix = False
        self.label_smoothing = float(model_cfg.get("label_smoothing", 0.0))
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError("model.label_smoothing must be in [0, 1) "
                             f"(got {self.label_smoothing})")
        self.focal_gamma = float(model_cfg.get("focal_gamma", 0.0))
        if self.focal_gamma < 0:
            raise ValueError(f"model.focal_gamma must be >= 0 (got {self.focal_gamma})")
        if self.focal_gamma and self.label_smoothing:
            raise ValueError("model.focal_gamma and model.label_smoothing cannot combine: "
                             "focal scaling is defined on the hard true-class "
                             "probability, smoothing redefines the targets. Pick one.")
        #: the network's dropout stream (flax's 'dropout' rng) and the host
        #: generator of random muting (the 'mute' rng)
        self.dropout_rng = DropoutRNG(seed, self.device)
        set_dropout_rng(self.network, self.dropout_rng)
        #: stochastic depth (the 'stochastic' rng): its own stream, advanced by
        #: every training forward's draws
        self.depth_rng = DepthRNG(seed)
        set_depth_rng(self.network, self.depth_rng)

    @abc.abstractmethod
    def build_network(self, generator: torch.Generator) -> torch.nn.Module:
        """Return the ``nn.Module`` implementing the forward pass."""

    @abc.abstractmethod
    def network_inputs(self, batch) -> Dict:
        """Map a batch dict to the network's call kwargs."""

    @abc.abstractmethod
    def feature_spec(self) -> Dict:
        """Per-sample ``{feature: (shape, dtype name)}`` the network takes."""

    def ce(self, logits, labels, weight=None):
        """Cross-entropy with the task's label smoothing / focal gamma."""
        from ..modules.losses import cross_entropy_loss

        return cross_entropy_loss(logits, labels, weight=weight,
                                  label_smoothing=self.label_smoothing,
                                  focal_gamma=self.focal_gamma)

    @abc.abstractmethod
    def step(self, batch, ctx, train: bool) -> Tuple[torch.Tensor, Dict]:
        """(total loss, aux) of one batch; aux holds 'losses', 'preds',
        'labels' and whatever else the task logs or dumps."""

    @abc.abstractmethod
    def setup_scores(self) -> List[Optional[Dict]]:
        """[train, val, test] dicts of metric accumulators (or Nones)."""

    def make_ctx(self, epoch: int, mode: str) -> Dict:
        return {"epoch": np.float32(epoch), "frozen": np.float32(0.0)}

    def frozen_param_names(self) -> Tuple[str, ...]:
        """Parameters whose gradients and updates stop when ctx['frozen'] is
        set. Default: none."""
        return ()

    def on_train_epoch_start(self, trainer, epoch: int) -> None:
        pass

    def on_train_epoch_end(self, trainer, epoch: int, logs: Dict[str, float]) -> None:
        pass

    def on_validation_epoch_end(self, trainer, epoch: int, logs: Dict[str, float]) -> None:
        pass

    def epoch_log_keys(self) -> Sequence[str]:
        return ()

    def test_artifact_keys(self) -> Sequence[str]:
        return ()


class MultiLossTask(TrainTask):
    """The multimodal multi-head-loss recipe: concrete tasks define
    ``modalities``, ``build_network``, ``branch_losses`` and ``predictions``."""

    modalities: Tuple[str, ...] = ()
    #: 'fixed_scaled' ((w_f*l_f + ow*sum(l_i)) * n), 'fixed' or 'sum'
    weighting: str = "fixed_scaled"
    #: where fusion_loss_weight anneals: 'val' (gated by loss_change_epoch),
    #: 'train_end', or None
    anneal_on: Optional[str] = "val"

    def __init__(self, model_cfg, optimizer_cfg=None, *, device=None, seed: int = 0):
        for key in _UNPORTED_MULTILOSS:
            if model_cfg.get(key):
                raise NotImplementedError(f"not yet ported: model.{key}")
        super().__init__(model_cfg, optimizer_cfg, device=device, seed=seed)
        self.log_confusion_matrix = True
        m = model_cfg
        self.mute = m.get("mute", None)
        self.freeze_modalities_on_epoch = m.get("freeze_modalities_on_epoch", None)
        self.random_modality_muting_on_freeze = m.get("random_modality_muting_on_freeze", False)
        self.muting_probs = m.get("muting_probs", None)
        n = self.num_branches
        self.fusion_loss_weight = float(m.get("fusion_loss_weight", 1.0 / n))
        self.fusion_loss_change = float(m.get("fusion_loss_change", 0))
        self.loss_change_epoch = int(m.get("loss_change_epoch", 0))
        #: eval-time modality ablation: every eval forward mutes this modality
        self.eval_mute_code: Optional[int] = None

        self.use_softadapt = bool(m.get("use_softadapt", False))
        if self.use_softadapt:
            self.loss_histories = [[] for _ in range(n)]
            self.loss_weights = np.full((n,), 1.0 / n, dtype=np.float32)
            self.update_loss_weights_per_epoch = int(m.get("update_loss_weights_per_epoch", 6))
            self.softadapt = LossWeightedSoftAdapt(
                beta=-0.1, accuracy_order=self.update_loss_weights_per_epoch - 1)

        # model.gradnorm: true, or a mapping with alpha and update_every
        gn_cfg = m.get("gradnorm", None)
        if gn_cfg and not hasattr(gn_cfg, "get"):
            gn_cfg = {}
        self.use_gradnorm = gn_cfg is not None and hasattr(gn_cfg, "get")
        if self.use_gradnorm:
            self.gn_alpha = float(gn_cfg.get("alpha", 1.5))
            self.gn_update_every = int(gn_cfg.get("update_every", 1))
            if self.gn_update_every < 1:
                raise ValueError("model.gradnorm.update_every must be >= 1 "
                                 f"(got {self.gn_update_every})")
            self.gn_weights: Optional[np.ndarray] = None
            self.gn_initial_losses: Optional[np.ndarray] = None
            if self.use_softadapt:
                raise ValueError(
                    "model.gradnorm and model.use_softadapt cannot combine: "
                    "both adapt the same loss-weight vector. Pick one.")

        self.use_gradblend = bool(m.get("gradblend", False))
        if self.use_gradblend and self.use_gradnorm:
            raise ValueError(
                "model.gradnorm and model.gradblend cannot combine: both "
                "adapt the same loss-weight vector. Pick one.")
        if self.use_gradblend:
            self.gb_update_freq = int(m.get("gb_update_freq", 20))
            #: sub-training sweeps a GradBlend estimate takes
            self.gb_epochs = int(m.get("gb_epochs", 20))
            self.gb_weights: Optional[np.ndarray] = None

    @property
    def num_branches(self) -> int:
        return len(self.modalities) + 1

    @property
    def loss_names(self) -> Tuple[str, ...]:
        return tuple(self.modalities) + ("fusion",)

    @abc.abstractmethod
    def branch_losses(self, outputs, batch, ctx) -> Dict[str, torch.Tensor]:
        """Per-branch scalar losses keyed by ``loss_names``."""

    @abc.abstractmethod
    def predictions(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """At least {'preds', 'labels'}."""

    def current_loss_weights(self) -> np.ndarray:
        """The weight vector (branch order = loss_names) for this epoch:
        SoftAdapt's, else GradBlend's once estimated, else GradNorm's once
        measured, else the weighting rule's."""
        n = self.num_branches
        if self.use_softadapt:
            return np.asarray(self.loss_weights, np.float32)
        if self.use_gradblend and self.gb_weights is not None:
            return np.asarray(self.gb_weights, np.float32)
        if self.use_gradnorm and self.gn_weights is not None:
            return np.asarray(self.gn_weights, np.float32)
        if self.weighting == "sum":
            return np.ones((n,), np.float32)
        ow = (1.0 - self.fusion_loss_weight) / (n - 1)
        w = np.full((n,), ow, dtype=np.float32)
        w[-1] = self.fusion_loss_weight
        if self.weighting == "fixed_scaled":
            w = w * n
        return w

    def _static_mute_code(self) -> int:
        if self.mute in (None, "multimodal"):
            return MUTE_NONE
        return list(self.modalities).index(self.mute)

    def make_ctx(self, epoch: int, mode: str) -> Dict:
        frozen = (self.freeze_modalities_on_epoch is not None
                  and epoch >= self.freeze_modalities_on_epoch)
        random_mute = bool(self.random_modality_muting_on_freeze and frozen)
        if mode != "train":
            mute_code = MUTE_NONE if self.eval_mute_code is None else int(self.eval_mute_code)
            random_mute, frozen_f = False, 0.0
        else:
            mute_code = self._static_mute_code()
            frozen_f = 1.0 if frozen else 0.0
        probs = np.zeros((len(self.modalities) + 1,), dtype=np.float32)
        if self.muting_probs is not None:
            for i, name in enumerate(self.modalities):
                probs[i] = float(self.muting_probs[name])
            probs[-1] = float(self.muting_probs.get("multimodal", 0.0))
        return {
            "epoch": np.float32(epoch),
            "loss_weights": self.current_loss_weights(),
            "frozen": np.float32(frozen_f),
            "mute_code": np.int32(mute_code),
            "random_mute": np.float32(1.0 if random_mute else 0.0),
            "mute_probs": probs,
        }

    def resolve_mute_code(self, ctx) -> int:
        """The step's mute code: the static one, or a categorical draw over
        (modalities..., 'multimodal') when random muting is active (one draw
        per step from the host generator; 'multimodal' mutes nothing)."""
        if ctx["random_mute"] <= 0:
            return int(ctx["mute_code"])
        p = torch.as_tensor(ctx["mute_probs"], dtype=torch.float64) + 1e-9
        drawn = int(torch.multinomial(p / p.sum(), 1, generator=self.dropout_rng.host))
        return MUTE_NONE if drawn >= len(self.modalities) else drawn

    def step(self, batch, ctx, train: bool):
        total, _, aux = self._step_parts(batch, ctx, train)
        return total, aux

    def step_components(self, batch, ctx, train: bool):
        """``(components, (total, aux))``: the per-branch weighted terms
        ``w_i * l_i`` (a tuple of scalars, order ``loss_names``) whose sum is
        ``step()``'s total; after the freeze epoch in training, zeros but the
        fusion loss. Each term is computed from its own branch loss, so its
        backward reaches only the modules that loss depends on: GradNorm
        takes one backward per term."""
        total, comps, aux = self._step_parts(batch, ctx, train)
        return comps, (total, aux)

    def _step_parts(self, batch, ctx, train: bool):
        mute_code = self.resolve_mute_code(ctx) if train else int(ctx["mute_code"])
        outputs = self.network(**self.network_inputs(batch), mute_code=mute_code)
        losses = self.branch_losses(outputs, batch, ctx)
        vec = torch.stack([losses[n] for n in self.loss_names])
        w = torch.as_tensor(ctx["loss_weights"], dtype=vec.dtype, device=vec.device)
        total = torch.dot(w, vec)
        comps = tuple(w[i] * losses[n] for i, n in enumerate(self.loss_names))
        if train and ctx["frozen"] > 0:
            # after freezing only the fusion head trains and only its loss
            # backpropagates (JAX base.py:719-724)
            total = losses["fusion"]
            comps = (*(torch.zeros_like(total) for _ in comps[:-1]), total)
        return total, comps, {"losses": losses, **self.predictions(outputs, batch)}

    def frozen_param_prefixes(self) -> Tuple[str, ...]:
        """Modules frozen at the freeze epoch: the modality encoders and their
        heads (the port's names of ``encoders_i`` / ``heads_i``); with paired
        encoders the one ``paired_encoder`` first, then the heads (JAX
        ``base.py:753-765``)."""
        paired = getattr(self.network, "paired_encoder", None) is not None
        names = ["paired_encoder."] if paired else []
        for i, _ in enumerate(self.modalities):
            names += [f"heads.{i}."] if paired else [f"encoders.{i}.", f"heads.{i}."]
        return tuple(names)

    def frozen_param_names(self) -> Tuple[str, ...]:
        prefixes = self.frozen_param_prefixes()
        return tuple(n for n, _ in self.network.named_parameters() if n.startswith(prefixes))

    def epoch_log_keys(self) -> Sequence[str]:
        return tuple(f"loss_{n}" for n in self.loss_names)

    def on_train_epoch_end(self, trainer, epoch: int, logs: Dict[str, float]) -> None:
        if self.anneal_on == "train_end":
            self.fusion_loss_weight = min(1.0, self.fusion_loss_weight + self.fusion_loss_change)

    def on_validation_epoch_end(self, trainer, epoch: int, logs: Dict[str, float]) -> None:
        if self.anneal_on == "val" and epoch >= self.loss_change_epoch:
            self.fusion_loss_weight = min(1.0, self.fusion_loss_weight + self.fusion_loss_change)
        if self.use_softadapt:
            for i, name in enumerate(self.loss_names):
                self.loss_histories[i].append(logs.get(f"val_loss_{name}", 0.0))
            if epoch != 0 and epoch % self.update_loss_weights_per_epoch == 0:
                self.loss_weights = self.softadapt.get_component_weights(
                    *[np.asarray(h, np.float64) for h in self.loss_histories]
                ).astype(np.float32)
                self.loss_histories = [[] for _ in self.loss_names]

    def on_train_epoch_start(self, trainer, epoch: int) -> None:
        if self.use_gradblend and epoch % self.gb_update_freq == 0:
            self.gb_weights = gradblend.estimate_gradblend_weights(self, trainer)
        if self.use_gradnorm and epoch % self.gn_update_every == 0:
            w = gradnorm.measure_gradnorm_weights(self, trainer, epoch)
            if w is not None:
                self.gn_weights = w

    def gradblend_modality_keys(self) -> Tuple[str, ...]:
        """Batch keys feeding each modality encoder (order = modalities)."""
        return tuple(self.modalities)

    def gradblend_loss(self, logits, batch):
        """GradBlend's sub-training criterion: plain cross-entropy, as JAX's."""
        return cross_entropy_loss(logits, batch["label"])
