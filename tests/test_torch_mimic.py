"""The port's MIMIC family against the JAX package, on the CPU.

- The blocks ``MLP``, ``MLPMixerNoPatching`` and ``GRU`` (its three output
  options; torch's ``nn.GRU`` with the weights of JAX's ``TorchGRUCell``, so
  the forward holds the gate order) against flax from the same weights,
  forward within 1e-5.
- The MIMIC H network (``MimicMixerMultiLoss``) and ``MimicRecurrent``
  (``mimic_gru.yml`` with ``gradblend`` off) at full width, batch 8, from one
  JAX parameter tree (the port's seeded weights in the JAX layout; JAX's own
  init would compile for nothing but the values) loaded through
  ``from_jax_params``: logits within 1e-5, the gradient of the task's loss
  (dropout 0) within 5e-5 x max(1, max|JAX|) per tensor, and the weights back
  through ``to_jax_params`` bit for bit.
- Three train steps of H, LC and task1 at dropout 0 (the JAX side: its task
  step, ``jax.value_and_grad`` and its trainer's optimizer): every loss within
  1e-5 relative. Adam's eps is 1e-3 here, as in
  ``tests/test_torch_training.py``: the token FFs' output biases have an
  exactly-zero gradient, float noise on each side, which Adam at the
  config's eps 1e-8 would turn into steps of lr in either direction.
- bench.py's bf16 levers (``model.precision=bf16``, tanh GELU, bits dropout)
  on the port against JAX's network at the same config, logits within 2e-2
  x max(1, max|JAX|). JAX's MIMIC builds its blocks without a compute dtype,
  so there the levers leave float32 math and only the GELU flavor changes;
  the port computes in bf16.
- ``MIMICDataModule`` on one ``gen_mimic`` pickle (the JAX package's
  surrogate, and the port's own copy of it, equal): every split array and
  label equal to JAX's, for ``task`` -1 and 1.
- ``AveragePrecision`` within 1e-6 of JAX's; the CLI trains and tests the H
  config on a surrogate pickle; ``export --pallas`` serves it;
  ``mimic_gru.yml`` builds with GradBlend on.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2mixer_tpu.config import apply_cli_overrides as j_apply_overrides
from m2mixer_tpu.config import load as jload
from m2mixer_tpu.datasets.mimic import MIMICDataModule as JMIMIC
from m2mixer_tpu.datasets.surrogate import gen_mimic as j_gen_mimic
from m2mixer_tpu.models import get_model as jget_model
from m2mixer_tpu.modules import get_block_by_name as jget_block
from m2mixer_tpu.modules.common import set_gelu_approximate
from m2mixer_tpu.training import metrics as jm
from m2mixer_tpu.training.trainer import _make_optimizer as j_make_optimizer
from m2mixer_tpu_torch import run, serving
from m2mixer_tpu_torch.config import apply_cli_overrides, load
from m2mixer_tpu_torch.datasets import MIMICDataModule
from m2mixer_tpu_torch.datasets.surrogate import gen_mimic
from m2mixer_tpu_torch.models import get_model
from m2mixer_tpu_torch.modules import get_block_by_name
from m2mixer_tpu_torch.training import metrics as pm
from m2mixer_tpu_torch.training.trainer import Trainer
from m2mixer_tpu_torch.utils.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_hygiene import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {name: os.path.join(REPO, "cfg", "mimic", f"{name}.yml")
        for name in ("mimic_m2-mixer_H", "mimic_m2-mixer_LC", "mimic_3loss_task1", "mimic_gru")}
FWD, GRAD, LOSS, BF16_REL = 1e-5, 5e-5, 1e-5, 2e-2
BLOCKS = {
    "MLP": (dict(block_type="MLP", input_dim=5, hidden_dim=64, num_blocks=2, output_dim=64),
            (8, 5)),
    "MLPMixerNoPatching": (dict(block_type="MLPMixerNoPatching", hidden_dim=64, num_patch=24,
                                num_mixers=1, token_dim=16, channel_dim=64, embedding_dim=12,
                                proj_dim=64), (8, 24, 12)),
    "GRU-flatten": (dict(block_type="GRU", input_dim=12, hidden_dim=30, flatten=True),
                    (8, 24, 12)),
    "GRU-last_only": (dict(block_type="GRU", input_dim=12, hidden_dim=30, last_only=True),
                      (8, 24, 12)),
    "GRU-has_padding": (dict(block_type="GRU", input_dim=12, hidden_dim=30, has_padding=True),
                        (8, 24, 12)),
}


def configs(name, *overrides):
    """(the JAX config, the port's) of a shipped MIMIC config with GradBlend
    off and the dotted ``overrides`` applied to both."""
    pair = jload(CFGS[name]), load(CFGS[name])
    for cfg, apply in zip(pair, (j_apply_overrides, apply_cli_overrides)):
        apply(cfg, ["model.gradblend=false", *overrides], warn=False)
    return pair


def mimic_batch(n=8, seed=0, classes=6):
    rng = np.random.RandomState(seed)
    return {"static": rng.randn(n, 5).astype(np.float32),
            "time": rng.randn(n, 24, 12).astype(np.float32),
            "label": rng.randint(0, classes, (n,)).astype(np.int32)}


def j_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_h():
    """The JAX H task, its initial weights and its jitted loss-and-gradient
    and train step, the context an argument: one compile serves H, LC and
    task1 (the same network; LC's loss weights and task1's labels arrive as
    data)."""
    jc, c = configs("mimic_m2-mixer_H", "model.dropout=0.0", "train.optimizer.eps=0.001")
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
    params = seeded_params(c)
    grad_fn = jax.value_and_grad(lambda p, b, ctx: jtask.step(p, b, ctx, {}, train=True),
                                 has_aux=True)
    opt, _ = j_make_optimizer(jtask.optimizer_cfg)

    @jax.jit
    def step(params, opt_state, batch, ctx):
        (loss, aux), grads = grad_fn(params, batch, ctx)
        updates, opt_state = opt.update(grads, opt_state, params)
        new = jax.tree.map(lambda p, u: p + u, params, updates)
        out = jtask.network.apply(params, (batch["static"], batch["time"]), deterministic=True)
        return new, opt_state, loss, aux["losses"], grads, out

    return dict(task=jtask, params=params, step=step, opt=opt)


def block_inputs(name):
    """x (and for has_padding the lengths) of a block case, numpy and JAX."""
    _, shape = BLOCKS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32)
    lengths = rng.randint(1, shape[1] + 1, (shape[0],)).astype(np.int32)
    return (x, lengths) if BLOCKS[name][0].get("has_padding") else x


@pytest.fixture(scope="module")
def flax_blocks():
    """Every block case's flax weights and output: all inits in one jitted
    call, all applies in another (one compile each)."""
    mods = {n: jget_block(**kw, dropout=0.0) for n, (kw, _) in BLOCKS.items()}
    xs = {n: jax.tree.map(jnp.asarray, block_inputs(n)) for n in BLOCKS}
    variables = j_tree(jax.jit(lambda key: {n: m.init(key, xs[n]) for n, m in mods.items()})(
        jax.random.PRNGKey(1)))
    outs = jax.jit(lambda v: {n: m.apply(v[n], xs[n]) for n, m in mods.items()})(variables)
    return variables, {n: np.asarray(o) for n, o in outs.items()}


def port_block(name, variables):
    block = get_block_by_name(**BLOCKS[name][0], dropout=0.0).eval()
    block.load_state_dict(from_jax_params(variables, block))
    return block


def port_out(block, name):
    x = block_inputs(name)
    with torch.no_grad():
        return block(tuple(map(torch.from_numpy, x)) if isinstance(x, tuple)
                     else torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_flax(name, flax_blocks):
    variables, outs = flax_blocks
    got = port_out(port_block(name, variables[name]), name)
    assert got.shape == outs[name].shape
    np.testing.assert_allclose(got, outs[name], rtol=0, atol=FWD)


def test_gru_gate_order_is_held(flax_blocks):
    """Swapping two gates of the JAX cell changes the port's output: the map
    puts each gate's rows where torch's (r, z, n) order reads them."""
    variables, outs = flax_blocks
    cell = variables["GRU-flatten"]["params"]["GRUCell_0"]
    swapped = {"params": {"GRUCell_0": {**cell, "ir": cell["iz"], "iz": cell["ir"]}}}
    got = port_out(port_block("GRU-flatten", swapped), "GRU-flatten")
    assert np.abs(got - outs["GRU-flatten"]).max() > 1e-3


def test_gru_map_raises_on_a_missing_or_misshaped_leaf(flax_blocks):
    variables, _ = flax_blocks
    block = get_block_by_name(**BLOCKS["GRU-flatten"][0], dropout=0.0)
    cell = dict(variables["GRU-flatten"]["params"]["GRUCell_0"])
    missing = {k: v for k, v in cell.items() if k != "hn"}
    with pytest.raises(ValueError, match="hn"):
        from_jax_params({"params": {"GRUCell_0": missing}}, block)
    bad = {**cell, "in": {"kernel": np.zeros((12, 31), np.float32), "bias": cell["in"]["bias"]}}
    with pytest.raises(ValueError, match="gate shapes"):
        from_jax_params({"params": {"GRUCell_0": bad}}, block)


def seeded_params(c):
    """The port's seeded initial weights in the JAX layout: both sides start
    from them (JAX's own init would compile for nothing but the values)."""
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu", seed=5)
    return to_jax_params(task.network.state_dict())


def port_task(c, params):
    task = get_model(c.model.type)(c.model, c.train.optimizer, device="cpu")
    task.network.load_state_dict(from_jax_params(params, task.network))
    return task


def j_ctx(jtask):
    return {k: jnp.asarray(v) for k, v in jtask.make_ctx(0, "train").items()}


def rel_close(got, want, tol):
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("name", ["mimic_m2-mixer_H", "mimic_gru"])
def test_networks_match_jax_forward_gradients_and_weights(name, jax_h):
    jc, c = configs(name, "model.dropout=0.0")
    if name == "mimic_m2-mixer_H":
        jtask, params, step, opt = (jax_h[k] for k in ("task", "params", "step", "opt"))
    else:
        jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)
        params = seeded_params(c)
        opt = j_make_optimizer(jtask.optimizer_cfg)[0]

        @jax.jit
        def step(params, opt_state, batch, ctx):
            (loss, aux), grads = jax.value_and_grad(
                lambda p: jtask.step(p, batch, ctx, {}, train=True), has_aux=True)(params)
            out = jtask.network.apply(params, (batch["static"], batch["time"]),
                                      deterministic=True)
            return params, opt_state, loss, aux["losses"], grads, out

    task = port_task(c, params)
    batch = mimic_batch(seed=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = task.network(**task.network_inputs(tb))
    _, _, j_loss, _, j_grads, jout = step(params, opt.init(params), batch, j_ctx(jtask))
    rel_close(out["logits"].detach().numpy(), np.asarray(jout["logits"]), FWD)
    for a, b in zip(out["branch_logits"], jout["branch_logits"]):
        rel_close(a.detach().numpy(), np.asarray(b), FWD)
    j_loss, j_grads = float(j_loss), j_tree(j_grads)
    task.network.train()
    loss, _ = task.step(tb, task.make_ctx(0, "train"), train=True)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - j_loss) <= FWD * max(1.0, abs(j_loss))
    grads = {k: p.grad for k, p in task.network.named_parameters()}
    got = flatten_tree(to_jax_params(grads)["params"])
    want = flatten_tree(j_grads["params"])
    assert set(got) == set(want)
    for path in want:
        rel_close(got[path], want[path], GRAD)
    back = flatten_tree(to_jax_params(task.network.state_dict())["params"])
    for path, leaf in flatten_tree(params["params"]).items():
        np.testing.assert_array_equal(back[path], leaf)


@pytest.mark.parametrize("name", ["mimic_m2-mixer_H", "mimic_m2-mixer_LC", "mimic_3loss_task1"])
def test_train_steps_match_jax(name, jax_h, tmp_path):
    jc, c = configs(name, "model.dropout=0.0", "train.optimizer.eps=0.001")
    jtask = jget_model(jc.model.type)(jc.model, jc.train.optimizer)  # its loss weights
    params = jax_h["params"]
    task = port_task(c, params)
    classes = 2 if name == "mimic_3loss_task1" else 6
    data = [mimic_batch(seed=10 + i, classes=classes) for i in range(3)]
    trainer = Trainer(c.train, work_dir=str(tmp_path))
    trainer.setup(task)
    pctx, ctx = task.make_ctx(0, "train"), j_ctx(jtask)
    np.testing.assert_array_equal(pctx["loss_weights"], np.asarray(ctx["loss_weights"]))
    opt_state = jax_h["opt"].init(params)
    for b in data:
        params, opt_state, j_loss, j_losses, _, _ = jax_h["step"](params, opt_state, b, ctx)
        loss, aux = trainer.train_step(task, trainer._to_device(task, b), pctx)
        assert abs(float(loss) - float(j_loss)) <= LOSS * max(1.0, abs(float(j_loss)))
        for k, v in j_losses.items():
            assert abs(aux["losses"][k].item() - float(v)) <= LOSS * max(1.0, abs(float(v))), k
    trainer.logger.close()


def test_bf16_levers_match_jax(jax_h):
    """The port at bench.py's levers (plain modules and both kernel block
    types of the fusion mixer) against JAX's network at the same config."""
    levers = ("model.precision=bf16", "model.approximate_gelu=true",
              "model.bits_dropout=true", "model.dropout=0.0")
    _, c = configs("mimic_m2-mixer_H", *levers)
    assert c.model.precision == "bf16" and c.model.approximate_gelu is True
    jtask, params = jax_h["task"], jax_h["params"]
    batch = mimic_batch(seed=6)
    prev = set_gelu_approximate(True)
    try:  # a fresh trace: the GELU flavor is a trace-time switch
        jout = jax.jit(lambda p, s, t: jtask.network.apply(p, (s, t), deterministic=True))(
            params, jnp.asarray(batch["static"]), jnp.asarray(batch["time"]))
    finally:
        set_gelu_approximate(prev)
    plain = port_task(c, params)
    state = plain.network.state_dict()
    for flavor in ("FusionMixer", "PallasStackedFusionMixer", "PallasFusionMixer"):
        task = plain if flavor == "FusionMixer" else serving.to_torch_kernel_serving(
            c, state, device="cpu", per_block=flavor == "PallasFusionMixer")[0]
        assert type(task.network.fusion_mixer).__name__ == flavor
        with torch.no_grad():
            out = task.network(**task.network_inputs({k: torch.from_numpy(v)
                                                      for k, v in batch.items()}))
        assert out["logits"].dtype == torch.bfloat16, flavor
        for a, b in zip((out["logits"], *out["branch_logits"]),
                        (jout["logits"], *jout["branch_logits"])):
            rel_close(a.float().numpy(), np.asarray(b), BF16_REL)


@pytest.mark.parametrize("task_id", [-1, 1])
def test_data_module_matches_jax(tmp_path, task_id):
    j_gen_mimic(str(tmp_path / "jax"), n=300, seed=2)
    gen_mimic(str(tmp_path / "port"), n=300, seed=2)
    with open(tmp_path / "jax" / "im.pk", "rb") as f, open(tmp_path / "port" / "im.pk", "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    jdm = JMIMIC(str(tmp_path / "jax"), task=task_id, batch_size=32)
    dm = MIMICDataModule(str(tmp_path / "port"), task=task_id, batch_size=32)
    jdm.setup("fit")
    dm.setup("fit")
    assert set(dm.splits) == set(jdm.splits) == {"train", "val", "test"}
    for split in dm.splits:
        assert set(dm.splits[split]) == {"static", "time", "label"}
        for k, v in jdm.splits[split].items():
            got = dm.splits[split][k]
            assert got.dtype == v.dtype and np.array_equal(got, v), (split, k)
    assert dm.split_size("train") == 240 and dm.split_size("val") == 30
    synth, jsynth = MIMICDataModule.synthetic(n=40, seed=3), JMIMIC.synthetic(n=40, seed=3)
    for split in jsynth.splits:
        for k, v in jsynth.splits[split].items():
            assert np.array_equal(synth.splits[split][k], v)


@pytest.mark.parametrize("average", ["macro", "weighted"])
def test_average_precision_matches_jax(average):
    rng = np.random.RandomState(7)
    scores = rng.rand(200, 6).astype(np.float32)
    scores[:50] = np.round(scores[:50], 1)  # ties
    labels = rng.randint(0, 6, 200)
    labels[labels == 5] = 4  # a class without positives
    a = pm.AveragePrecision(task="multiclass", num_classes=6, average=average)
    b = jm.AveragePrecision(task="multiclass", num_classes=6, average=average)
    for i in range(0, 200, 64):
        a.update(scores[i:i + 64], labels[i:i + 64])
        b.update(scores[i:i + 64], labels[i:i + 64])
    assert abs(a.compute() - b.compute()) <= 1e-6
    binary = (pm.AveragePrecision(task="binary"), jm.AveragePrecision(task="binary"))
    for m in binary:
        m.update(scores[:, 0], (labels == 0).astype(np.int64))
    assert abs(binary[0].compute() - binary[1].compute()) <= 1e-6


def test_cli_trains_and_serves_mimic_h(tmp_path):
    """``run`` trains and tests the H config on a surrogate pickle (one epoch,
    the metrics under the JAX keys, ``auroc`` among them); ``serving export
    --pallas`` of its best weights answers as the plain artifact does."""
    data = str(tmp_path / "data")
    gen_mimic(data, n=100, seed=1)
    trainer = run.main(["-c", CFGS["mimic_m2-mixer_H"], "-n", "h", "--device", "cpu",
                        f"dataset.params.data_dir={data}", "train.epochs=1",
                        f"train.tensorboard_path={tmp_path}", "dataset.params.num_workers=0"])
    logs = trainer.callback_metrics
    for key in ("test_loss", "test_loss_static", "test_loss_time", "test_loss_fusion",
                "test_acc", "test_f1_micro", "test_auroc", "val_auroc", "train_auroc"):
        assert np.isfinite(logs[key]), key
    best = trainer.best_path()
    for pallas in (False, True):
        serving.main(["export", "-c", CFGS["mimic_m2-mixer_H"], "-p", best, "--device", "cpu",
                      "-o", str(tmp_path / f"art{int(pallas)}"), *(["--pallas"] if pallas else [])])
    plain, kernel = (serving.load_serving(str(tmp_path / f"art{i}"), device="cpu")
                     for i in (0, 1))
    assert kernel.meta["block_flavor"] == "kernel"
    assert kernel.meta["features"] == {"static": [5], "time": [24, 12]}
    feats = {k: v for k, v in mimic_batch(n=37, seed=9).items() if k != "label"}
    np.testing.assert_allclose(kernel.predict(feats)["logits"], plain.predict(feats)["logits"],
                               rtol=0, atol=1e-5)


def test_mimic_gru_resolves_then_raises_for_gradblend():
    """``mimic_gru.yml`` resolves ``MimicRecurrent`` and builds with GradBlend
    on, as shipped (its estimates against JAX: ``test_torch_gradblend.py``)."""
    c = load(CFGS["mimic_gru"])
    cls = get_model(c.model.type)
    assert cls.__name__ == "MimicRecurrent"
    task = cls(c.model, c.train.optimizer, device="cpu")
    assert task.use_gradblend and (task.gb_update_freq, task.gb_epochs) == (20, 20)
    assert task.gb_weights is None and hasattr(task.network, "fusion_encoder")
