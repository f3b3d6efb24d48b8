"""The port's optimizers against optax on the same gradients.

Both packages get the same parameters (bridged) and the same sequence of
numpy gradients, so only the optimizer is compared: per-group clipping, the
schedule read at count 0, AdamW with weight decay, accumulation. Parameters
within 1e-6 after 6 updates; schedules within 1e-7 at every count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_bridge import bridged_pair, by_port_name, tiny_params
from videoitg_tpu.ops.quant import quantize_grounding_int8, quantize_qwen2_int4
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu.train import optimizer as jax_optimizer
from videoitg_tpu_torch.train import lora, optimizer


@pytest.mark.parametrize("kind", ["cosine", "constant"])
@pytest.mark.parametrize("total,ratio", [(6, 0.05), (10, 0.3), (100, 0.05), (1, 0.05), (40, 0.5)])
def test_schedule_matches_optax_at_every_count(kind, total, ratio):
    want = jax_optimizer.make_schedule(2e-4, total, ratio, kind)
    got = optimizer.make_schedule(2e-4, total, ratio, kind)
    assert got(0) == 0.0  # the first update has learning rate 0
    for count in range(total + 3):
        assert abs(got(count) - float(want(count))) < 1e-7, count


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        optimizer.make_schedule(1e-3, 10, 0.1, "linear")


def _variants():
    base = tiny_params(seed=3)
    return {
        "dense": base,
        "dense+lora": jax_lora.add_lora(base, jax.random.PRNGKey(1), rank=4),
        "int8+lora": jax_lora.add_lora(quantize_grounding_int8(base), jax.random.PRNGKey(1),
                                       rank=4),
        "int4+lora": jax_lora.add_lora(dict(base, lm=quantize_qwen2_int4(base["lm"])),
                                       jax.random.PRNGKey(1), rank=4),
    }


@pytest.fixture(scope="module")
def variants():
    return _variants()


def _jax_trainable(tx, params):
    """Names (port spelling) of the leaves an optax transform moves, found
    by one update on all-ones gradients with a non-zero learning rate."""
    grads = jax.tree.map(lambda p: jnp.ones_like(p) if jnp.issubdtype(p.dtype, jnp.floating)
                         else jnp.zeros_like(p), params)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)  # count 0: lr 0
    updates, _ = tx.update(grads, state, params)
    return {name for name, u in by_port_name(updates).items() if np.any(u != 0)}


@pytest.mark.parametrize("tune_projector_only", [False, True])
@pytest.mark.parametrize("variant", ["dense", "dense+lora", "int8+lora", "int4+lora"])
def test_grounding_label_tree_trains_the_same_leaves(variants, variant, tune_projector_only):
    params, model = bridged_pair(variants[variant])
    kw = dict(total_steps=4, warmup_ratio=0.5, tune_projector_only=tune_projector_only)
    want = _jax_trainable(jax_optimizer.make_grounding_optimizer(params, **kw), params)
    tx = optimizer.make_grounding_optimizer(model, **kw)
    assert set(tx.trainable_names()) == want
    assert {n for n, p in model.named_parameters() if p.requires_grad} == want
    assert not any(n.startswith("vision.") for n in want)


@pytest.mark.parametrize("out_proj_lr", [None, 1e-3])
@pytest.mark.parametrize("variant", ["dense+lora", "int8+lora", "int4+lora"])
def test_lora_labels_train_the_same_leaves(variants, variant, out_proj_lr):
    params, model = bridged_pair(variants[variant])
    kw = dict(total_steps=4, warmup_ratio=0.5, out_proj_lr=out_proj_lr)
    want = _jax_trainable(jax_lora.make_lora_optimizer(params, **kw), params)
    tx = lora.make_lora_optimizer(model, **kw)
    assert set(tx.trainable_names()) == want
    assert all(".lora_" in n or n.startswith("out_proj.") for n in want)
    assert any(n.startswith("out_proj.") for n in want) == (out_proj_lr is not None)


def _drive(params, model, jax_tx, port_tx, n_calls, seed, group_scales):
    """Feed the same numpy gradients to both optimizers `n_calls` times;
    `group_scales` scales the gradients by top-level key, so that one group
    is clipped and another is not. Returns the largest parameter difference
    and, per call, whether each port group would have been clipped."""
    rng = np.random.default_rng(seed)
    names = port_tx.trainable_names()
    shapes = by_port_name(jax.tree.map(np.asarray, params))
    state = jax_tx.init(params)
    for _ in range(n_calls):
        flat = {}
        for name, arr in shapes.items():
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            scale = group_scales.get(name.split(".")[0], 1.0)
            flat[name] = (rng.standard_normal(arr.shape) * scale).astype(np.float32)
        # Stack the per-layer gradients back into the JAX tree's form.
        def leaf(path, p):
            keys = [str(getattr(k, "key", k)) for k in path]
            if not jnp.issubdtype(p.dtype, jnp.floating):
                return jnp.zeros_like(p)
            if "layers" in keys:
                i = keys.index("layers")
                head, rest = ".".join(keys[:i + 1]), ".".join(keys[i + 1:])
                return jnp.stack([flat[f"{head}.{l}.{rest}"] for l in range(p.shape[0])])
            return jnp.asarray(flat[".".join(keys)])
        grads = jax.tree_util.tree_map_with_path(leaf, params)
        updates, state = jax_tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        port_tx.apply([torch.from_numpy(np.asarray(flat[n])) for n in names])
    want = by_port_name(jax.tree.map(np.asarray, params))
    port = dict(model.named_parameters())
    # Relative to the leaf's size where that is above 1 (lora_scale is 8.0,
    # where one fp32 ulp is 9.5e-7).
    diffs = {n: float(np.abs(port[n].detach().numpy() - want[n]).max()
                      / max(1.0, np.abs(want[n]).max())) for n in names}
    moved = {n for n in names if np.any(want[n] != shapes[n])}
    frozen_same = all(np.array_equal(p.detach().numpy(), want[n])
                      for n, p in port.items() if n not in names)
    return diffs, moved, frozen_same


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_grounding_optimizer_matches_optax(accum_steps, schedule):
    params, model = bridged_pair(tiny_params(seed=4))
    # max_grad_norm 1.0: the LM's gradients (norm in the hundreds) are
    # clipped, the head's (scaled down to a norm below 1) are not.
    kw = dict(learning_rate=1e-3, out_proj_lr=5e-3, projector_lr=2e-3, weight_decay=0.1,
              total_steps=6, warmup_ratio=0.34, schedule=schedule, max_grad_norm=1.0,
              accum_steps=accum_steps)
    jax_tx = jax_optimizer.make_grounding_optimizer(params, **kw)
    port_tx = optimizer.make_grounding_optimizer(model, **kw)
    diffs, moved, frozen_same = _drive(params, model, jax_tx, port_tx, 6 * accum_steps, 21,
                                       {"out_proj": 1e-3})
    assert max(diffs.values()) < 1e-6, max(diffs, key=diffs.get)
    assert moved == set(port_tx.trainable_names()) and frozen_same


# optax.MultiSteps cannot average the int8 leaves of a quantised tree, so
# accumulation is compared on the dense base only.
@pytest.mark.parametrize("variant,accum_steps", [("dense+lora", 1), ("dense+lora", 2),
                                                 ("int8+lora", 1), ("int4+lora", 1)])
def test_lora_optimizer_matches_optax(variants, variant, accum_steps):
    params, model = bridged_pair(variants[variant])
    kw = dict(learning_rate=1e-3, out_proj_lr=5e-3, total_steps=6, warmup_ratio=0.34,
              weight_decay=0.1, max_grad_norm=1.0, accum_steps=accum_steps)
    jax_tx = jax_lora.make_lora_optimizer(params, **kw)
    port_tx = lora.make_lora_optimizer(model, **kw)
    diffs, moved, frozen_same = _drive(params, model, jax_tx, port_tx, 6 * accum_steps, 22,
                                       {"out_proj": 1e-3})
    assert max(diffs.values()) < 1e-6, max(diffs, key=diffs.get)
    assert moved == set(port_tx.trainable_names()) and frozen_same


def test_clipping_is_per_group_not_global():
    """One small and one huge group: the small group's update must not shrink
    because the other group's norm is large."""
    _, model = bridged_pair(tiny_params(seed=5))
    tx = optimizer.make_grounding_optimizer(model, learning_rate=1e-3, out_proj_lr=1e-3,
                                            total_steps=4, warmup_ratio=0.5, max_grad_norm=1.0)
    names = tx.trainable_names()
    grads = [torch.full_like(p, 100.0) if not n.startswith("out_proj.") else
             torch.full_like(p, 1e-3) for n, p in zip(names, tx.params)]
    seen = {}
    step = tx.optimizer.step

    def spy():
        seen.update({n: p.grad.clone() for n, p in zip(names, tx.params)})
        step()

    tx.optimizer.step = spy
    tx.apply(grads)
    assert torch.equal(seen["out_proj.w"], torch.full_like(seen["out_proj.w"], 1e-3))
    base_norm = optimizer.global_norm([g for n, g in seen.items()
                                       if tx and not n.startswith(("out_proj.", "projector."))])
    assert abs(float(base_norm) - 1.0) < 1e-5


def test_accumulation_advances_once_per_k_calls():
    _, model = bridged_pair(tiny_params(seed=6))
    tx = optimizer.make_grounding_optimizer(model, total_steps=8, warmup_ratio=0.5,
                                            accum_steps=3)
    before = [p.detach().clone() for p in tx.params]
    ones = [torch.ones_like(p) for p in tx.params]
    for call in range(1, 7):
        tx.apply(ones)
        assert tx.scheduler.last_epoch == call // 3
    # First update (after call 3) had lr 0; the second (after call 6) moved.
    assert any(not torch.equal(a, p) for a, p in zip(before, tx.params))
    state = tx.state_dict()
    assert state["mini_step"] == 0 and state["accumulated"] is None
