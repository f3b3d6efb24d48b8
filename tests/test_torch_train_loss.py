"""`grounding_loss` of the port against the JAX package on bridged weights.

preset("tiny"), fp32, CPU; the JAX side reaches its Pallas training kernels
in interpret mode when `use_flash=True`, the port its kernels' plain
versions. Loss and metrics within 1e-5; gradients of every leaf that trains
within rtol 1e-3 (of the leaf's largest entry) of `jax.grad`.
"""

import numpy as np
import pytest
import torch

import jax

from _torch_bridge import bridged_pair, by_port_name, make_batches, tiny_params
from videoitg_tpu.config import preset
from videoitg_tpu.models.grounding import grounding_loss as jax_grounding_loss
from videoitg_tpu_torch.models.grounding import grounding_logits, grounding_loss
from videoitg_tpu_torch.train.optimizer import _label_tree


@pytest.fixture(scope="module")
def pair():
    return bridged_pair(tiny_params())


def _port_loss_and_grads(model, batch, cfg, hw, **kw):
    labels = _label_tree(model)
    names = [n for n, _ in model.named_parameters() if labels[n] != "frozen"]
    params = dict(model.named_parameters())
    for n in names:
        params[n].requires_grad_(True)
    loss, metrics = grounding_loss(model, batch, cfg, hw, **kw)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    for n in names:
        params[n].requires_grad_(False)
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("form", ["frames", "features"])
def test_loss_metrics_and_gradients_match_jax(pair, form, use_flash):
    params, model = pair
    cfg = preset("tiny")
    jb, tb = make_batches(cfg, 11, form)
    hw = 2

    def loss_fn(p):
        return jax_grounding_loss(p, jb, cfg, hw=hw, use_flash=use_flash, remat=True,
                                  freeze_vision=True)

    (want_loss, want_metrics), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, metrics, grads = _port_loss_and_grads(model, tb, cfg, hw, use_flash=use_flash)
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
    assert set(metrics) == set(want_metrics) == {"loss", "pos_weight", "pos_frac"}
    for key in metrics:
        assert abs(float(metrics[key]) - float(want_metrics[key])) < 1e-5, key
    want = by_port_name(want_grads)
    assert grads and all(n.split(".")[0] != "vision" for n in grads)
    for name, g in grads.items():
        ref = want[name]
        g = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(g - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-9, name
    # The frozen tower gets no gradient in JAX either.
    assert all(not np.any(v) for k, v in want.items() if k.startswith("vision."))


@pytest.mark.parametrize("form", ["frames", "features"])
def test_remat_changes_nothing(pair, form):
    _, model = pair
    cfg = preset("tiny")
    _, tb = make_batches(cfg, 12, form)
    a = _port_loss_and_grads(model, tb, cfg, 2, use_flash=True, remat=True)
    b = _port_loss_and_grads(model, tb, cfg, 2, use_flash=True, remat=False)
    assert torch.equal(a[0], b[0])
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


def test_unfrozen_tower_gets_gradients_with_and_without_remat(pair):
    _, model = pair
    cfg = preset("tiny")
    _, tb = make_batches(cfg, 13, "frames")
    w = model.vision.layers[0].q.w
    w.requires_grad_(True)
    try:
        grads = []
        for remat in (True, False):
            loss, _ = grounding_loss(model, tb, cfg, 2, use_flash=True, remat=remat,
                                     freeze_vision=False)
            grads.append(torch.autograd.grad(loss, w)[0])
        assert grads[0].abs().max() > 0 and torch.equal(grads[0], grads[1])
        head = model.out_proj.w.requires_grad_(True)
        loss, _ = grounding_loss(model, tb, cfg, 2, freeze_vision=True)
        frozen, trained = torch.autograd.grad(loss, (w, head), allow_unused=True)
        assert frozen is None and trained.abs().max() > 0
    finally:
        w.requires_grad_(False)
        model.out_proj.w.requires_grad_(False)


def test_vision_chunk_and_feature_form_skip_nothing_else(pair):
    """vision_chunk runs the tower over frame chunks with the same result;
    features equal to the tower's output give the frames form's logits."""
    from videoitg_tpu_torch.models.grounding import GroundingBatch, vision_features

    _, model = pair
    cfg = preset("tiny")
    _, tb = make_batches(cfg, 14, "frames")
    whole = grounding_logits(model, tb, cfg, 2)
    chunked = grounding_logits(model, tb, cfg, 2, vision_chunk=2)
    assert torch.allclose(whole, chunked, atol=1e-6)
    b, t = tb.frame_valid.shape
    feats = vision_features(model, tb.frames.reshape((b * t,) + tuple(tb.frames.shape[2:])), cfg)
    fb = GroundingBatch(feats.reshape(b, t, *feats.shape[1:]), *tb[1:])
    assert torch.equal(grounding_logits(model, fb, cfg, 2), whole)


def test_pos_weight_is_capped_and_labels_required(pair):
    _, model = pair
    cfg = preset("tiny")
    _, tb = make_batches(cfg, 15, "features", b=1, t_bucket=8, t_reals=(8,), l_txt=(4,))
    labels = torch.zeros(1, 8)
    labels[0, 0] = 1.0  # sqrt(7 / 1) < 5: uncapped
    _, m = grounding_loss(model, tb._replace(labels=labels), cfg, 1)
    assert abs(float(m["pos_weight"]) - 7 ** 0.5) < 1e-6
    _, m = grounding_loss(model, tb._replace(labels=torch.zeros(1, 8)), cfg, 1)
    assert abs(float(m["pos_weight"]) - 8 ** 0.5) < 1e-6  # neg / max(1, 0)
    _, wide = make_batches(cfg, 16, "features", b=1, t_bucket=32, t_reals=(32,), l_txt=(4,))
    labels = torch.zeros(1, 32)
    labels[0, 3] = 1.0  # sqrt(31) > 5: capped
    _, m = grounding_loss(model, wide._replace(labels=labels), cfg, 1)
    assert float(m["pos_weight"]) == cfg.max_pos_weight == 5.0
    assert abs(float(m["pos_frac"]) - 1 / 32) < 1e-7
    with pytest.raises(ValueError, match="labels"):
        grounding_loss(model, tb._replace(labels=None), cfg, 1)
