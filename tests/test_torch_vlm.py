"""The port's causal VLM (videoitg_tpu_torch/models/vlm.py) against the JAX
package's, on bridged weights: packing, SFT loss and its gradients,
loglikelihood, KV-cache prefill / decode logits, greedy generation (tokens
must be identical), stop sequences, bucket padding, and the golden tokens.

fp32 on the CPU, `preset("tiny")` in its causal, tied variant; inputs from
numpy seeds. Tolerances: loss 1e-5, gradients 1e-3 of each leaf's largest
entry, loglikelihood 1e-4, logits 2e-4 absolute / 1e-3 relative (the JAX
package's own bound for its cache against a full forward).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from _torch_bridge import by_port_name, causal_cfgs, to_numpy_tree
from videoitg_tpu.models import qwen2 as jax_qwen2
from videoitg_tpu.models import vlm as jax_vlm
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu_torch.checkpoint import params_from_numpy, params_to_numpy
from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.constants import IGNORE_INDEX
from videoitg_tpu_torch.models import qwen2 as qwen2_mod
from videoitg_tpu_torch.models import vlm

HW = 2


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = causal_cfgs()
    params = jax_init_grounding(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(to_numpy_tree(params), cfg)
    return jcfg, params, cfg, model


def make_batches(cfg, seed, b=1, t_bucket=2, t_reals=(2,), l_pre=3, n_pre=(3,), l_post=6,
                 n_post=(6,), labels=True):
    """The same packed batch for both packages: (jax VLMBatch, port VLMBatch).
    Sample i has t_reals[i] real frames, n_pre[i] / n_post[i] real tokens."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    frames = np.zeros((b, t_bucket, s, s, 3), np.float32)
    fv = np.zeros((b, t_bucket), bool)
    pre, pv = np.zeros((b, l_pre), np.int32), np.zeros((b, l_pre), bool)
    post, qv = np.zeros((b, l_post), np.int32), np.zeros((b, l_post), bool)
    lab = np.full((b, l_post), IGNORE_INDEX, np.int32)
    for i in range(b):
        frames[i, :t_reals[i]] = rng.standard_normal((t_reals[i], s, s, 3))
        fv[i, :t_reals[i]] = True
        pre[i, :n_pre[i]] = rng.integers(1, cfg.lm.vocab_size, n_pre[i])
        pv[i, :n_pre[i]] = True
        post[i, :n_post[i]] = rng.integers(1, cfg.lm.vocab_size, n_post[i])
        qv[i, :n_post[i]] = True
        lab[i, n_post[i] // 2:n_post[i]] = post[i, n_post[i] // 2:n_post[i]]
    arrays = [frames, fv, pre, pv, post, qv] + ([lab] if labels else [])
    return (jax_vlm.VLMBatch(*(jnp.asarray(a) for a in arrays)),
            vlm.VLMBatch(*(torch.from_numpy(a) for a in arrays)))


SHAPES = {
    "one sample": dict(),
    "two samples, padded frames and text": dict(
        b=2, t_bucket=4, t_reals=(4, 2), l_pre=5, n_pre=(5, 3), l_post=8, n_post=(8, 5)),
}


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_embeds_equal(setup, shape):
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 1, **SHAPES[shape])
    jx, jvalid, jpos, jn = jax_vlm._pack_embeds(params, jb, jcfg, HW, False, False, True)
    x, valid, pos, n_img = vlm._pack_embeds(model, tb, cfg, HW, False, False, True)
    assert n_img == jn
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("remat", [False, True])
def test_vlm_loss_matches_jax(setup, shape, remat):
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 2, **SHAPES[shape])
    want, jm = jax_vlm.vlm_loss(params, jb, jcfg, hw=HW, remat=remat)
    got, m = vlm.vlm_loss(model, tb, cfg, hw=HW, remat=remat)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    assert int(m["num_label_tokens"]) == int(jm["num_label_tokens"]) > 0
    assert m["loss"].item() == got.item() and not m["loss"].requires_grad


@pytest.mark.parametrize("shape", SHAPES)
def test_vlm_loss_gradients_match_jax(setup, shape):
    """A full finetune's gradients (tower frozen, as in the step)."""
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 3, **SHAPES[shape])
    jgrads = jax.grad(lambda p: jax_vlm.vlm_loss(p, jb, jcfg, hw=HW)[0])(params)
    want = by_port_name(to_numpy_tree(jgrads))
    named = {n: p for n, p in model.named_parameters() if not n.startswith("vision.")}
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss, _ = vlm.vlm_loss(model, tb, cfg, hw=HW)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        for p in named.values():
            p.requires_grad_(False)
    checked = 0
    for (name, _), g in zip(named.items(), grads):
        w = want[name]
        if g is None:  # the scoring head: unused by the VLM
            assert name.startswith("out_proj.") and not np.any(w)
            continue
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-3, err_msg=name)
        checked += 1
    assert checked > 20
    assert all(not np.any(v) for k, v in want.items() if k.startswith("vision."))


def test_vlm_loss_refuses_a_batch_without_labels_and_a_non_causal_config(setup):
    _, _, cfg, model = setup
    _, tb = make_batches(cfg, 4, labels=False)
    with pytest.raises(ValueError, match="post_labels"):
        vlm.vlm_loss(model, tb, cfg, hw=HW)
    with pytest.raises(ValueError, match="post_labels"):
        vlm.vlm_loglikelihood(model, tb, cfg, hw=HW)
    _, tb = make_batches(cfg, 4)
    with pytest.raises(ValueError, match="causal"):
        vlm.vlm_loss(model, tb, GroundingConfig.tiny(), hw=HW)
    with pytest.raises(ValueError, match="causal"):
        vlm.vlm_generate(model, tb, GroundingConfig.tiny(), hw=HW)


@pytest.mark.parametrize("shape", SHAPES)
def test_vlm_loglikelihood_matches_jax(setup, shape):
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 5, **SHAPES[shape])
    jll, jgreedy = jax_vlm.vlm_loglikelihood(params, jb, jcfg, hw=HW)
    ll, greedy = vlm.vlm_loglikelihood(model, tb, cfg, hw=HW)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    assert ll.dtype == torch.float32 and greedy.dtype == torch.bool


def test_loglikelihood_of_the_greedy_continuation_is_greedy(setup):
    """Label the tokens that generation emits: `is_greedy` must come out True
    in both packages, and False once one label is changed."""
    jcfg, params, cfg, model = setup
    _, tb = make_batches(cfg, 6, l_post=4, n_post=(4,), labels=False)
    new = vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=3)
    post = torch.cat([tb.post_ids, new], dim=1)
    labels = torch.cat([torch.full_like(tb.post_ids, IGNORE_INDEX), new], dim=1)
    for flip, expect in ((False, True), (True, False)):
        lab = labels.clone()
        if flip:
            lab[0, -1] = (lab[0, -1] + 1) % cfg.lm.vocab_size
        batch = tb._replace(post_ids=post, post_valid=torch.ones_like(post, dtype=torch.bool),
                            post_labels=lab)
        ll, greedy = vlm.vlm_loglikelihood(model, batch, cfg, hw=HW)
        jbatch = jax_vlm.VLMBatch(*(jnp.asarray(t.numpy()) for t in batch))
        jll, jgreedy = jax_vlm.vlm_loglikelihood(params, jbatch, jcfg, hw=HW)
        assert bool(greedy[0]) is expect and bool(jgreedy[0]) is expect
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_prefill_and_decode_logits_match_jax(setup, shape):
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 7, labels=False, **SHAPES[shape])
    jx, jvalid, jpos, _ = jax_vlm._pack_embeds(params, jb, jcfg, HW, False, False, True)
    n_steps = 4
    jlast, jcache = jax_vlm.vlm_prefill(params["lm"], jx, jvalid, jpos, jcfg.lm,
                                        max_len=jx.shape[1] + n_steps)
    with torch.no_grad():
        x, valid, pos, _ = vlm._pack_embeds(model, tb, cfg, HW, False, False, True)
        last, cache = vlm.vlm_prefill(model.lm, x, valid, pos, cfg.lm,
                                      max_len=x.shape[1] + n_steps)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4, rtol=1e-3)
    assert cache.k.shape == tuple(jcache.k.shape) and cache.write_idx == int(jcache.write_idx)
    np.testing.assert_array_equal(cache.mask.numpy(), np.asarray(jcache.mask))
    np.testing.assert_array_equal(cache.next_pos.numpy(), np.asarray(jcache.next_pos))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=2e-4, rtol=1e-3)

    jlogits = jax_qwen2.lm_logits(params["lm"], jlast[:, None, :], jcfg.lm)[:, 0]
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for _ in range(n_steps - 1):
        jlogits, jcache = jax_vlm.vlm_decode_step(params, jnp.asarray(tok), jcache, jcfg.lm)
        with torch.no_grad():
            logits, cache = vlm.vlm_decode_step(model, torch.from_numpy(tok), cache, cfg.lm)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4, rtol=1e-3)
        assert logits.dtype == torch.float32
        np.testing.assert_array_equal(cache.mask.numpy(), np.asarray(jcache.mask))
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    assert cache.write_idx == int(jcache.write_idx) == x.shape[1] + n_steps - 1


def test_decode_step_takes_the_lm_alone(setup):
    _, _, cfg, model = setup
    _, tb = make_batches(cfg, 8, labels=False)
    outs = []
    for owner in (model, model.lm):
        with torch.no_grad():
            x, valid, pos, _ = vlm._pack_embeds(model, tb, cfg, HW, False, False, True)
            _, cache = vlm.vlm_prefill(model.lm, x, valid, pos, cfg.lm, max_len=x.shape[1] + 1)
            outs.append(vlm.vlm_decode_step(owner, torch.tensor([5]), cache, cfg.lm)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("shape", SHAPES)
def test_vlm_generate_tokens_identical(setup, shape, seed):
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, seed, labels=False, **SHAPES[shape])
    want = np.asarray(jax_vlm.vlm_generate(params, jb, jcfg, hw=HW, max_new_tokens=6))
    got = vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_vlm_generate_eos_and_live_stop_sequences(setup):
    """Generation halts inside the loop: after eos, or once the trailing
    tokens match a stop sequence, every later slot is the eos id. Both
    packages agree token for token."""
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 2, labels=False)
    free = vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=6, eos_token_id=-1).numpy()
    stop = (int(free[0, 1]), int(free[0, 2]))
    kw = dict(hw=HW, max_new_tokens=6, eos_token_id=-1, stop_sequences=(stop,))
    out = vlm.vlm_generate(model, tb, cfg, **kw).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_vlm.vlm_generate(params, jb, jcfg, **kw)))
    np.testing.assert_array_equal(out[0, :3], free[0, :3])
    assert (out[0, 3:] == -1).all(), out
    toks = vlm.truncate_at_stop_sequences(torch.from_numpy(out), stop_sequences=[list(stop)],
                                          eos_token_id=-1)
    assert toks == [[int(free[0, 0])]]
    assert toks == jax_vlm.truncate_at_stop_sequences(out, [list(stop)], -1)
    # eos: the second emitted token ends the sample.
    kw = dict(hw=HW, max_new_tokens=6, eos_token_id=int(free[0, 1]))
    out = vlm.vlm_generate(model, tb, cfg, **kw).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_vlm.vlm_generate(params, jb, jcfg, **kw)))
    assert out[0, 0] == free[0, 0] and (out[0, 1:] == free[0, 1]).all()
    # A stop sequence longer than the budget, and an empty one, are ignored.
    out = vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=3,
                           stop_sequences=((1, 2, 3, 4), ())).numpy()
    np.testing.assert_array_equal(out, free[:, :3])


@pytest.mark.parametrize("rows", [
    [[5, 6, 7, -1, -1]], [[5, 6, 7, 8, 9], [6, 7, 1, 2, 3]], [[-1, 5, 6, 7, 8]]])
def test_truncate_at_stop_sequences_equal(rows):
    for stops in (None, [[6, 7]], [[9, 9], [7]]):
        assert vlm.truncate_at_stop_sequences(np.asarray(rows), stops, -1) == \
            jax_vlm.truncate_at_stop_sequences(np.asarray(rows), stops, -1)


def _bucketed(cfg, t_bucket, seed, labels):
    """One sample of 2 real frames padded into a bucket of `t_bucket`."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    frames = np.zeros((1, t_bucket, s, s, 3), np.float32)
    frames[:, :2] = rng.standard_normal((1, 2, s, s, 3))
    fv = np.zeros((1, t_bucket), bool)
    fv[:, :2] = True
    pre = rng.integers(1, cfg.lm.vocab_size, (1, 3)).astype(np.int32)
    post = rng.integers(1, cfg.lm.vocab_size, (1, 5)).astype(np.int32)
    arrays = [frames, fv, pre, np.ones((1, 3), bool), post, np.ones((1, 5), bool)]
    if labels:
        arrays.append(post.copy())
    return vlm.VLMBatch(*(torch.from_numpy(a) for a in arrays))


def test_generate_with_padded_frames_matches_compact(setup):
    """The cache must mask pad holes mid-sequence, not assume a valid prefix."""
    _, _, cfg, model = setup
    compact = vlm.vlm_generate(model, _bucketed(cfg, 2, 9, False), cfg, hw=HW, max_new_tokens=4)
    padded = vlm.vlm_generate(model, _bucketed(cfg, 4, 9, False), cfg, hw=HW, max_new_tokens=4)
    assert torch.equal(padded, compact)


def test_vlm_loss_padded_frames_matches_compact(setup):
    """The first post token is predicted from the last VALID image slot, so
    bucket padding cannot change the loss."""
    _, _, cfg, model = setup
    compact, _ = vlm.vlm_loss(model, _bucketed(cfg, 2, 10, True), cfg, hw=HW, remat=False)
    padded, _ = vlm.vlm_loss(model, _bucketed(cfg, 4, 10, True), cfg, hw=HW, remat=False)
    np.testing.assert_allclose(padded.item(), compact.item(), atol=1e-5, rtol=1e-5)


def test_golden_vlm_tokens_reproduced_by_the_port():
    """tests/golden/tiny_vlm_tokens.json, the JAX package's own fixture."""
    jcfg, cfg = causal_cfgs()
    params = jax_init_grounding(jax.random.PRNGKey(77), jcfg, dtype=jnp.float32)
    model = params_from_numpy(to_numpy_tree(params), cfg)
    rng = np.random.default_rng(77)
    frames = rng.standard_normal((1, 2, 56, 56, 3)).astype(np.float32)
    pre = rng.integers(1, 500, (1, 3)).astype(np.int32)
    post = rng.integers(1, 500, (1, 4)).astype(np.int32)
    batch = vlm.VLMBatch(
        frames=torch.from_numpy(frames), frame_valid=torch.ones(1, 2, dtype=torch.bool),
        pre_ids=torch.from_numpy(pre), pre_valid=torch.ones(1, 3, dtype=torch.bool),
        post_ids=torch.from_numpy(post), post_valid=torch.ones(1, 4, dtype=torch.bool))
    toks = vlm.vlm_generate(model, batch, cfg, hw=2, max_new_tokens=6).tolist()
    path = os.path.join(os.path.dirname(__file__), "golden", "tiny_vlm_tokens.json")
    with open(path) as f:
        assert toks == json.load(f)


@pytest.mark.parametrize("use_flash", [True, "train", "train-jax"])
def test_kernel_arms_on_the_cpu_equal_the_plain_path(setup, use_flash):
    """On CPU tensors every kernel wrapper runs its plain version: the loss and
    the generated tokens of each arm equal the `use_flash=False` path's. The
    valid rows agree; only they reach the loss and the cache's mask."""
    _, _, cfg, model = setup
    _, tb = make_batches(cfg, 14, **SHAPES["two samples, padded frames and text"])
    want, _ = vlm.vlm_loss(model, tb, cfg, hw=HW)
    got, _ = vlm.vlm_loss(model, tb, cfg, hw=HW, use_flash=use_flash)
    np.testing.assert_allclose(got.item(), want.item(), atol=1e-5, rtol=1e-5)
    if use_flash is True:
        tokens = vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=4, use_flash=True)
        assert torch.equal(tokens, vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=4))


def test_train_jax_arm_through_the_whole_model_matches_jax(setup):
    """`use_flash="train-jax"` in the tower and the LM on both sides: the JAX
    package's library kernel in TPU interpret mode, the port's plain version
    of its segment-id kernels. Loss and LM gradients."""
    jcfg, params, cfg, model = setup
    jb, tb = make_batches(cfg, 15, **SHAPES["two samples, padded frames and text"])
    with pltpu.force_tpu_interpret_mode():
        (want, _), jgrads = jax.value_and_grad(
            lambda p: jax_vlm.vlm_loss(p, jb, jcfg, hw=HW, use_flash="train-jax", remat=False),
            has_aux=True)(params)
    wanted = by_port_name(to_numpy_tree(jgrads))
    named = {n: p for n, p in model.named_parameters() if n.startswith(("lm.", "projector."))}
    for p in named.values():
        p.requires_grad_(True)
    try:
        got, _ = vlm.vlm_loss(model, tb, cfg, hw=HW, use_flash="train-jax", remat=False)
        grads = torch.autograd.grad(got, list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    for (name, _), g in zip(named.items(), grads):
        scale = max(np.abs(wanted[name]).max(), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, wanted[name] / scale, atol=1e-3,
                                   err_msg=name)


def test_untied_lm_head_logits_and_the_bridge_both_ways():
    """An untied causal LM reads its logits through `lm.lm_head`; the numpy
    bridge carries the head both ways and builds no scoring head for a tree
    that has none."""
    jcfg, cfg = causal_cfgs(tie=False)
    params = jax_init_grounding(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    params = dict(params)
    params["lm"] = jax_qwen2.init_qwen2(jax.random.PRNGKey(4), jcfg.lm, dtype=jnp.float32,
                                        with_lm_head=True)
    del params["out_proj"]
    tree = to_numpy_tree(params)
    model = params_from_numpy(tree, cfg)
    assert not hasattr(model, "out_proj") and tuple(model.lm.lm_head.w.shape) == (48, 512)
    hidden = np.random.default_rng(0).standard_normal((2, 5, 48)).astype(np.float32)
    want = jax_qwen2.lm_logits(params["lm"], jnp.asarray(hidden), jcfg.lm)
    got = qwen2_mod.lm_logits(model.lm, torch.from_numpy(hidden), cfg.lm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    back = params_to_numpy(model)
    assert "out_proj" not in back
    flat_a, flat_b = by_port_name(tree), by_port_name(back)
    assert flat_a.keys() == flat_b.keys() and "lm.lm_head.w" in flat_a
    for key in flat_a:
        assert np.array_equal(flat_a[key], flat_b[key]), key
    # The untied model generates like the JAX package's.
    jb, tb = make_batches(cfg, 16, labels=False)
    np.testing.assert_array_equal(
        vlm.vlm_generate(model, tb, cfg, hw=HW, max_new_tokens=4).numpy(),
        np.asarray(jax_vlm.vlm_generate(params, jb, jcfg, hw=HW, max_new_tokens=4)))


def test_lm_logits_tied_is_the_transposed_embedding(setup):
    jcfg, params, cfg, model = setup
    hidden = np.random.default_rng(1).standard_normal((1, 3, 48)).astype(np.float32)
    want = jax_qwen2.lm_logits(params["lm"], jnp.asarray(hidden), jcfg.lm)
    got = qwen2_mod.lm_logits(model.lm, torch.from_numpy(hidden), cfg.lm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert not hasattr(qwen2_mod.Qwen2(cfg.lm, with_lm_head=True), "lm_head")  # tied: no head
