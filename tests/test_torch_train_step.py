"""Training trajectories of the port against the JAX package.

preset("tiny"), fp32, CPU, the same start (bridged) and the same batches from
numpy seeds: 4 calls of `make_train_step` for a dense full finetune, LoRA r4
and QLoRA over an int8 base. Loss at every step within 1e-4 of JAX, the
trained leaves within 1e-4 at the end; the vision tower and the quantised
leaves bit-identical to the start. `grad_norm` is compared with the JAX
gradients' norm over the leaves that train (the port differentiates no other
leaf; the JAX metric runs over all of them).
"""

import numpy as np
import pytest
import torch

import jax

from _torch_bridge import bridged_pair, by_port_name, make_batches, tiny_params
from videoitg_tpu.config import preset
from videoitg_tpu.models.grounding import grounding_loss as jax_grounding_loss
from videoitg_tpu.ops.quant import quantize_grounding_int8
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu.train import optimizer as jax_optimizer
from videoitg_tpu.train import train_step as jax_train_step
from videoitg_tpu_torch.train import lora, optimizer, train_step

OPT = dict(total_steps=4, warmup_ratio=0.3, max_grad_norm=1.0, weight_decay=0.01)


def _setup(kind):
    base = tiny_params(seed=9)
    if kind == "full":
        params, model = bridged_pair(base)
        kw = dict(OPT, learning_rate=1e-3, out_proj_lr=5e-3)
        return (params, jax_optimizer.make_grounding_optimizer(params, **kw), model,
                optimizer.make_grounding_optimizer(model, **kw))
    if kind == "qlora":
        base = quantize_grounding_int8(base)
    params, model = bridged_pair(jax_lora.add_lora(base, jax.random.PRNGKey(2), rank=4))
    # Adam turns a gradient entry of rounding-noise size (lora_a right after
    # B leaves 0) into a step of up to lr, so lr bounds how far one such
    # entry can part the two packages: 1e-3 keeps that under the 1e-4 bound.
    kw = dict(OPT, learning_rate=1e-3, out_proj_lr=5e-3)
    return (params, jax_lora.make_lora_optimizer(params, **kw), model,
            lora.make_lora_optimizer(model, **kw))


@pytest.mark.parametrize("kind,form,use_flash", [("full", "frames", True),
                                                 ("lora", "features", True),
                                                 ("qlora", "features", False)])
def test_four_step_trajectory_matches_jax(kind, form, use_flash):
    cfg = preset("tiny")
    params, jax_tx, model, port_tx = _setup(kind)
    start = {n: t.detach().clone() for n, t in model.state_dict().items()}
    trainable = set(port_tx.trainable_names())
    hw = 2
    jax_state = jax_train_step.create_train_state(params, jax_tx)
    jax_step = jax_train_step.make_train_step(cfg, jax_tx, hw=hw, use_flash=use_flash)
    state = train_step.create_train_state(model, port_tx)
    step_fn = train_step.make_train_step(cfg, port_tx, hw=hw, use_flash=use_flash)
    for i in range(4):
        jb, tb = make_batches(cfg, 30 + i, form)
        # The JAX gradients' norm over the leaves that train, from the state
        # the step is about to use.
        grads = jax.grad(lambda p: jax_grounding_loss(
            p, jb, cfg, hw=hw, use_flash=use_flash, remat=True, freeze_vision=True)[0],
            allow_int=True)(jax_state.params)
        flat = by_port_name(grads)
        want_norm = np.sqrt(sum(float(np.sum(np.square(flat[n].astype(np.float64))))
                                for n in trainable))
        jax_state, want = jax_train_step.run_step(jax_step, jax_state, jb)
        state, got = train_step.run_step(step_fn, state, tb)
        assert state.step == int(jax_state.step) == i + 1
        assert set(got) == set(want) == {"loss", "pos_weight", "pos_frac", "grad_norm"}
        assert abs(float(got["loss"]) - float(want["loss"])) < 1e-4, i
        assert abs(float(got["grad_norm"]) - want_norm) < 1e-3 * want_norm + 1e-6, i
    want = by_port_name(jax.tree.map(np.asarray, jax_state.params))
    end = model.state_dict()
    for name in trainable:
        scale = max(1.0, float(np.abs(want[name]).max()))
        assert np.abs(end[name].numpy() - want[name]).max() < 1e-4 * scale, name
    changed = {n for n in end if not torch.equal(end[n], start[n])}
    assert changed and changed <= trainable
    assert not any(n.startswith("vision.") for n in changed)
    if kind == "qlora":
        ints = [n for n, t in end.items() if t.dtype == torch.int8]
        assert ints and all(torch.equal(end[n], start[n]) for n in ints)
    if kind != "full":
        assert all(".lora_" in n or n.startswith("out_proj.") for n in changed)


def test_first_update_has_zero_learning_rate():
    cfg = preset("tiny")
    _, _, model, tx = _setup("lora")
    before = [p.detach().clone() for p in tx.params]
    state = train_step.create_train_state(model, tx)
    step_fn = train_step.make_train_step(cfg, tx, hw=2)
    _, tb = make_batches(cfg, 40, "features")
    state, m1 = train_step.run_step(step_fn, state, tb)
    assert all(torch.equal(a, p) for a, p in zip(before, tx.params))
    state, m2 = train_step.run_step(step_fn, state, tb)
    assert float(m1["loss"]) == float(m2["loss"])  # nothing moved yet
    assert any(not torch.equal(a, p) for a, p in zip(before, tx.params))
    assert state.step == 2


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_repeating_one_batch_drives_the_loss_down(kind):
    cfg = preset("tiny")
    _, model = bridged_pair(tiny_params(seed=11))
    kw = dict(total_steps=30, warmup_ratio=0.1, schedule="constant", max_grad_norm=1.0)
    if kind == "lora":
        lora.add_lora(model, torch.Generator().manual_seed(0), rank=4)
        tx = lora.make_lora_optimizer(model, learning_rate=1e-2, out_proj_lr=1e-2, **kw)
    else:
        tx = optimizer.make_grounding_optimizer(model, learning_rate=1e-3, out_proj_lr=1e-2, **kw)
    state = train_step.create_train_state(model, tx)
    step_fn = train_step.make_train_step(cfg, tx, hw=2, use_flash=True)
    _, tb = make_batches(cfg, 42, "features")
    losses = []
    for _ in range(30):
        state, m = train_step.run_step(step_fn, state, tb)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses[::5]


def test_accumulation_counts_every_call():
    cfg = preset("tiny")
    _, model = bridged_pair(tiny_params(seed=10))
    tx = optimizer.make_grounding_optimizer(model, total_steps=4, warmup_ratio=0.3,
                                            accum_steps=2)
    state = train_step.create_train_state(model, tx)
    step_fn = train_step.make_train_step(cfg, tx, hw=2)
    _, tb = make_batches(cfg, 41, "features")
    for call in range(1, 5):
        state, _ = train_step.run_step(step_fn, state, tb)
        assert state.step == call and tx.scheduler.last_epoch == call // 2


def test_run_step_refuses_a_mesh():
    """A mesh that is not a DeviceMesh is refused (meshes train since the
    multi-device slice: tests/test_torch_parallel_train*.py)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        train_step.run_step(lambda s, b: (s, {}), None, None, mesh=object())
