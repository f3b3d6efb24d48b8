"""The residual add + LayerNorm of the vision towers (ops/layer_norm.py) and
the tower's inference loop that carries each residual add into it
(models/siglip.py `_encoder_layers_carried`).

On the CPU `add_layer_norm` runs its plain version, which is the plain
loop's own sequence (bias add, residual add, `common.layer_norm`): the
carried loop must give the plain loop's numbers bit for bit, and the JAX
package's within the model tests' tolerance. The kernel itself is checked
on the card (tests/test_torch_layer_norm_card.py, `-m card`).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_clip import _both, _cfgs, _spliced_checkpoint
from videoitg_tpu.config import GroundingConfig as JaxConfig
from videoitg_tpu.models import siglip as jax_siglip
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.ops import quant as jax_quant
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models import common, siglip
from videoitg_tpu_torch.ops import layer_norm as ln_ops
from videoitg_tpu_torch.ops.quant import QuantLinear, quantize_linear_int8

TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_models.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEARS = ("q", "k", "v", "o", "fc1", "fc2")


def _norm(rng, h, dtype):
    norm = common.Norm(h, bias=True, dtype=dtype)
    norm.scale.data = torch.from_numpy(1 + 0.1 * rng.standard_normal(h).astype(np.float32)).to(dtype)
    norm.bias.data = torch.from_numpy(0.1 * rng.standard_normal(h).astype(np.float32)).to(dtype)
    return norm


@pytest.mark.parametrize("form", ["no delta", "delta", "delta and bias"])
@pytest.mark.parametrize("h", [1152, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_plain_sequence_bit_for_bit(dtype, h, form):
    rng = np.random.default_rng(h)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32)).to(dtype)

    x = randn(2, 5, h, scale=4.0)
    delta = randn(2, 5, h) if form != "no delta" else None
    bias = randn(h, scale=0.5) if form == "delta and bias" else None
    norm = _norm(rng, h, dtype)
    r, y = ln_ops.add_layer_norm(x, delta, bias, norm, 1e-6)
    # the plain loop: `linear` adds the bias to the product, the layer adds
    # the product to the stream, then `layer_norm`
    want_r = x
    if delta is not None:
        want_r = x + ((delta + bias) if bias is not None else delta)
    assert r.dtype == y.dtype == dtype
    assert torch.equal(r, want_r)
    assert torch.equal(y, common.layer_norm(norm, want_r, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrapper_never_steps_aside_to_the_plain_version_off_the_cpu(dtype):
    """Off the CPU the wrapper launches the kernel or raises: an fp32 stream
    (or one on a device the kernel cannot reach) is refused, never run
    plainly."""
    norm = common.Norm(16, bias=True, device="meta", dtype=dtype)
    x = torch.zeros(4, 16, device="meta", dtype=dtype)
    with pytest.raises(ValueError):
        ln_ops.add_layer_norm(x, None, None, norm, 1e-6)
    with pytest.raises(ValueError):
        ln_ops.add_layer_norm(x, x, x[0], norm, 1e-6)


def _perturbed(tree, rng):
    """LN scales and biases away from ones and zeros, biases away from zero,
    so that every operand of the carried adds and norms counts."""
    for name in ("ln1", "ln2"):
        for key, base in (("scale", 1.0), ("bias", 0.0)):
            a = tree["vision"]["layers"][name][key]
            tree["vision"]["layers"][name][key] = (
                base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    for name in LINEARS:
        b = tree["vision"]["layers"][name]["b"]
        tree["vision"]["layers"][name]["b"] = (0.05 * rng.standard_normal(b.shape)).astype(b.dtype)
    return tree


def _tower(arch: str):
    """(JAX vision params, port tower, JAX and port vision configs) on the
    same numbers: tiny with the SigLIP tower, tiny with every tower linear in
    int4, or HF CLIP's tiny tower through both packages' converters."""
    if arch == "clip":
        jcfg, cfg = _cfgs()
        params, model = _both(_spliced_checkpoint()[0], jcfg, cfg)
        return params["vision"], model.vision, jcfg.vision, cfg.vision
    jcfg, cfg = JaxConfig.tiny(), GroundingConfig.tiny()
    params = jax_init_grounding(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    tree = _perturbed(jax.tree.map(np.asarray, params), np.random.default_rng(5))
    if arch == "int4":
        for name in LINEARS:
            tree["vision"]["layers"][name] = jax.tree.map(
                np.asarray, jax_quant.quantize_linear_int4(tree["vision"]["layers"][name]))
    model = params_from_numpy(tree, cfg)
    return tree["vision"], model.vision, jcfg.vision, cfg.vision


def _images(vcfg, t=3, seed=1):
    s = vcfg.image_size
    return np.random.default_rng(seed).standard_normal((t, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", ["siglip", "clip", "int4"])
def test_carried_loop_matches_jax(arch, use_flash):
    jparams, tower, jvcfg, vcfg = _tower(arch)
    if arch == "int4":
        assert isinstance(tower.layers[0].fc2, QuantLinear) and tower.layers[0].fc2.bits == 4
    images = _images(vcfg)
    want = jax_siglip.siglip_features(jparams, jnp.asarray(images), jvcfg, use_flash=use_flash)
    with torch.inference_mode():
        got = siglip.siglip_features(tower, torch.from_numpy(images), vcfg, use_flash=use_flash)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _lora(tower, rng):
    for layer in tower.layers:
        for name in ("o", "fc2"):
            lin = getattr(layer, name)
            d_in, d_out = lin.w.shape
            common.set_lora(lin, torch.from_numpy(rng.standard_normal((d_in, 2)).astype(np.float32)),
                            torch.from_numpy(rng.standard_normal((2, d_out)).astype(np.float32)),
                            torch.tensor(0.5))
    return tower


def _act8(tower):
    """Every tower linear int8 with act_q, as the act8 tier makes them."""
    for layer in tower.layers:
        for name in LINEARS:
            q = quantize_linear_int8(getattr(layer, name))
            q.act_q = True
            setattr(layer, name, q)
    return tower


CARRIED_CASES = [("siglip", torch.float32, None), ("siglip", torch.bfloat16, None),
                 ("clip", torch.float32, None), ("clip", torch.bfloat16, None),
                 ("int4", torch.bfloat16, None), ("siglip", torch.float32, "lora"),
                 ("siglip", torch.float32, "act8 fused off"),
                 ("siglip", torch.float32, "act8 fused on")]


@pytest.mark.parametrize("arch,dtype,form", CARRIED_CASES)
def test_carried_loop_is_the_plain_loop_bit_for_bit(monkeypatch, arch, dtype, form):
    """With `use_flash=True` under inference mode the loop carries the
    residual adds into `add_layer_norm`: 2 a layer, 1 more for CLIP's
    pre-layernorm, none where the fused act8 layer runs. With gradients on
    the plain loop runs and never calls it; both give the same bits."""
    from videoitg_tpu_torch.ops.quant import Act8Switches

    _, tower, _, vcfg = _tower(arch)
    if form == "lora":
        tower = _lora(tower, np.random.default_rng(3))
    elif form is not None:
        tower = _act8(tower)
    tower = tower.to(dtype)
    act8 = Act8Switches(fused=form == "act8 fused on")
    use_flash = True  # the inference kernels: on the CPU, their plain versions
    images = torch.from_numpy(_images(vcfg)).to(dtype)
    calls = []
    real = ln_ops.add_layer_norm

    def counted(*args):
        calls.append(args[1] is not None)
        return real(*args)

    monkeypatch.setattr(siglip, "add_layer_norm", counted)
    want = siglip.siglip_features(tower, images, vcfg, use_flash=use_flash, act8=act8)
    assert calls == []
    with torch.inference_mode():
        got = siglip.siglip_features(tower, images, vcfg, use_flash=use_flash, act8=act8)
    layers = vcfg.num_effective_layers
    if form == "act8 fused on":
        assert calls == []
    else:
        # CLIP's pre-layernorm and layer 1's ln1 take no delta, every other norm one
        opening = [False] * (2 if arch == "clip" else 1)
        assert calls == opening + [True] * (2 * layers - 1)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_flash", [False, "train"])
@pytest.mark.parametrize("arch", ["siglip", "clip"])
def test_without_the_inference_kernels_the_plain_tower_runs(monkeypatch, arch, use_flash):
    """`use_flash=False` is the all-plain tower, and a training arm keeps
    the plain loop, with or without a gradient: the kernel never runs."""
    _, tower, _, vcfg = _tower(arch)

    def refused(*args):
        raise AssertionError(f"add_layer_norm ran with use_flash={use_flash!r}")

    images = torch.from_numpy(_images(vcfg))
    want = siglip.siglip_features(tower, images, vcfg, use_flash=use_flash)
    monkeypatch.setattr(siglip, "add_layer_norm", refused)
    with torch.inference_mode():
        got = siglip.siglip_features(tower, images, vcfg, use_flash=use_flash)
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["siglip", "clip"])
def test_grad_enabled_keeps_the_plain_loop_and_backpropagates(monkeypatch, arch, remat):
    _, tower, _, vcfg = _tower(arch)

    def refused(*args):
        raise AssertionError("add_layer_norm ran with gradients on")

    monkeypatch.setattr(siglip, "add_layer_norm", refused)
    for p in tower.parameters():
        p.requires_grad_(True)
    images = torch.from_numpy(_images(vcfg)).requires_grad_(True)
    out = siglip.siglip_features(tower, images, vcfg, remat=remat)
    out.square().mean().backward()
    for layer in tower.layers[: vcfg.num_effective_layers]:
        for g in (layer.ln1.scale.grad, layer.ln2.bias.grad, layer.o.b.grad, layer.fc2.w.grad):
            assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    assert images.grad is not None and images.grad.abs().sum() > 0


@pytest.mark.parametrize("form", ["dense", "lora", "int8", "tp"])
def test_linear_held_bias_holds_back_only_a_plain_dense_bias(monkeypatch, form):
    rng = np.random.default_rng(9)
    lin = common.Linear(16, 8)
    lin.w.data = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    lin.b.data = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    if form == "lora":
        common.set_lora(lin, torch.ones(16, 2), torch.ones(2, 8), torch.tensor(0.5))
    elif form == "int8":
        lin = quantize_linear_int8(lin)
    elif form == "tp":
        # a tp slice runs its collective in `linear` (parallel/tensor.py); a
        # marker and a stand-in for `linear` show which way the call goes
        lin.tp = object()
        monkeypatch.setattr(common, "linear", lambda p, a, act8=None: a[:, :8] * 2)
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    y, b = common.linear_held_bias(lin, x)
    if form == "dense":
        assert b is lin.b and torch.equal(y, x @ lin.w)
        assert torch.equal(y + b, common.linear(lin, x))
    else:
        assert b is None and torch.equal(y, common.linear(lin, x))


def test_profile_groups_put_the_kernel_in_its_own_group():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_request", os.path.join(REPO, "scripts", "torch_profile_request.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    name = ("void videoitg::add_layer_norm_kernel<5>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
            "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
            "__nv_bfloat16*, int, int, float)")
    assert module.group_of(name) == "add_layer_norm"


def test_the_tracer_reads_the_launch_count():
    from videoitg_tpu_torch.utils import profiling

    assert ("videoitg_tpu_torch.ops.layer_norm", "add_layer_norm") in profiling.LAUNCH_COUNTERS
    assert profiling.launches()["add_layer_norm"] == ln_ops.add_layer_norm.launches
