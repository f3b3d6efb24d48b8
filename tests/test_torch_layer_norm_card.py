"""The add + LayerNorm kernel (csrc/layer_norm.cu) against its plain version
at the towers' chunks: SigLIP's 128 frames [93,312, 1152] and CLIP's
[73,856, 1024], with a delta and a bias, a delta alone and neither. r is
bit-equal; y is within 1 bf16 ulp (the spacing of 2^-8 below it: a
normalised value's fp32 terms are of order 1, and their summation order
may move a result near 0 by more than its own spacing).

`pytest -m card tests/test_torch_layer_norm_card.py` on a machine with an
NVIDIA GPU; skipped without one. The kernel's times and the tower's launch
counts are chip_smoke.py's (`--only layer-norm`).
"""

import pytest
import torch

from videoitg_tpu_torch.models.common import Norm
from videoitg_tpu_torch.ops.layer_norm import add_layer_norm, add_layer_norm_reference


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor, floor: float = 2.0 ** -8) -> float:
    ref = ref.float()
    spacing = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(floor))) - 7)
    return ((out.float() - ref).abs() / spacing).max().item()


@pytest.mark.card
@pytest.mark.parametrize("form", ["delta and bias", "delta", "no delta"])
@pytest.mark.parametrize("rows,h,eps", [(93312, 1152, 1e-6), (73856, 1024, 1e-5)])
def test_kernel_matches_plain_version(rows, h, eps, form):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(h)

    def randn(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)

    x = randn(rows, h, std=4.0)
    delta = randn(rows, h) if form != "no delta" else None
    bias = randn(h, std=0.5) if form == "delta and bias" else None
    ln = Norm(h, bias=True, device=dev, dtype=torch.bfloat16)
    ln.scale.data, ln.bias.data = randn(h, mean=1.0, std=0.1), randn(h, std=0.1)
    r, y = add_layer_norm(x, delta, bias, ln, eps)
    r_ref, y_ref = add_layer_norm_reference(x, delta, bias, ln, eps)
    assert torch.equal(r, r_ref)
    assert bf16_ulps(y, y_ref) <= 1.0
    if bias is not None:  # the tolerance catches a dropped bias
        assert bf16_ulps(add_layer_norm(x, delta, None, ln, eps)[1], y_ref) > 1.0
