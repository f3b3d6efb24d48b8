"""Probe: kernels F (`act8_gemm`) and H (`fused_ln_mlp_int8`) timed outside
chip_smoke.py, in this checkout, in variants of it and in other checkouts.

    python3 scripts/torch_probes/int8_gemm_probe.py [OTHER_CHECKOUT ...]

F as `act8_linear` calls it (the row scale made, then the product) at the
LM's four shapes, M = 13,056 tokens: (K, N) = (3584, 3584), (3584, 512),
(3584, 18944), (18944, 3584), and the 7 launches of one layer; H at the
tower's [93,312, 1152] via 4304 (gelu_tanh), whole and, where the checkout
has them, launch by launch. Each result is held to its plain version
(F: error in bf16 ulps of max|ref|; H: error over chip_smoke.py's
`int8_tol`). The variants are copies of this checkout's package under
build/int8_gemm_probe/ with constants of a csrc file changed (VARIANTS).
Order: others, this, the variants, this, the others in reverse; each
checkout in its own process with its own build. Needs one card. Times:
chip_smoke.py's CUDA-event timer, 10 launches of F (5 of H) after one
warm-up.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANT_ROOT = os.path.join(HERE, "build", "int8_gemm_probe")
# tag -> (header under csrc/, {constant: value})
VARIANTS = {
    "groups of 8 row tiles": ("hopper_int8_gemm.cuh", {"kGroupM": 8}),
}
F_SHAPES = {(3584, 3584): 2, (3584, 512): 2, (3584, 18944): 2, (18944, 3584): 1}
TOKENS = 512 * 25 + 256
ROWS, WIDTH, INTER = 128 * 729, 1152, 4304


def _smoke():
    """chip_smoke.py of this checkout, for its timer and tolerances."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_checkout(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from videoitg_tpu_torch.models.common import Linear, Norm
    from videoitg_tpu_torch.ops import fused_encoder as fe
    from videoitg_tpu_torch.ops import quant_gemm as qg
    from videoitg_tpu_torch.ops.quant import quantize_linear_int8

    smoke = _smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def int8_linear(d_in, d_out, bias_std=None):
        lin = Linear(d_in, d_out, bias=bias_std is not None, device=dev, generator=gen)
        if bias_std is not None:
            lin.b.data = torch.randn(d_out, generator=gen, device=dev) * bias_std
        q = quantize_linear_int8(lin)
        q.act_q = True
        return q.to(torch.bfloat16)

    out = {"tag": tag, "f": {}, "h": {}}
    layer = 0.0
    for (k, n), count in F_SHAPES.items():
        lin = int8_linear(k, n)
        x = torch.randn(TOKENS, k, generator=gen, device=dev).to(torch.bfloat16)
        got = qg.act8_linear(lin, x)
        ref = qg.act8_gemm_reference(x, qg.row_scale(x), lin.w_qt, lin.scale)
        ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        ms = smoke.cuda_ms(lambda: qg.act8_linear(lin, x), 10)
        out["f"][f"{k}x{n}"] = dict(ms=ms, err_ulps=(got.float() - ref.float()).abs().max().item()
                                    / ulp, tops=2 * TOKENS * k * n / ms / 1e9)
        layer += count * ms
        del lin, x, got, ref
    out["f"]["layer"] = layer

    ln = Norm(WIDTH, bias=True, device=dev, dtype=torch.bfloat16)
    ln.scale.data = (1.0 + 0.1 * torch.randn(WIDTH, generator=gen, device=dev)).to(torch.bfloat16)
    ln.bias.data = (0.3 * torch.randn(WIDTH, generator=gen, device=dev)).to(torch.bfloat16)
    fc1, fc2 = int8_linear(WIDTH, INTER, bias_std=0.1), int8_linear(INTER, WIDTH, bias_std=0.5)
    x = torch.randn(ROWS, WIDTH, generator=gen, device=dev).to(torch.bfloat16)
    act, eps = "gelu_tanh", 1e-6
    got = fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act)
    ref = fe.fused_ln_mlp_int8_reference(x, ln, fc1, fc2, eps, act)
    out["h"]["err_over_tol"] = (got.float() - ref.float()).abs().max().item() / smoke.int8_tol(
        ref.float())
    out["h"]["ms"] = smoke.cuda_ms(lambda: fe.fused_ln_mlp_int8(x, ln, fc1, fc2, eps, act), 5)
    if hasattr(fe, "mlp_ln_quant"):
        yq, ys = fe.mlp_ln_quant(x, ln, eps)
        amax = fe.mlp_fc1_amax(yq, ys, fc1, act)
        gq = fe.mlp_fc1_quant(yq, ys, fc1, amax, act)
        out["h"]["launches_ms"] = [
            smoke.cuda_ms(lambda: fe.mlp_ln_quant(x, ln, eps), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc1_amax(yq, ys, fc1, act), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc1_quant(yq, ys, fc1, amax, act), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc2_residual(x, gq, amax, fc2), 5)]
    print("PROBE " + json.dumps(out), flush=True)


def variant(tag: str, header: str, change: dict) -> str:
    """A copy of this checkout's package with `change` applied to the
    constants of csrc/`header`."""
    root = os.path.join(VARIANT_ROOT, re.sub(r"[^A-Za-z0-9]+", "_", tag))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "videoitg_tpu_torch"),
                    os.path.join(root, "videoitg_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    path = os.path.join(root, "videoitg_tpu_torch", "csrc", header)
    with open(path) as f:
        text = f.read()
    for name, value in change.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{tag}: constant {name} not found in {path}")
    with open(path, "w") as f:
        f.write(text)
    return root


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one_checkout(argv[1])
        return 0
    others = [(os.path.abspath(p), "other " + p) for p in argv]
    middle = [(variant(tag, *change), tag) for tag, change in VARIANTS.items()]
    order = others + [(HERE, "this")] + middle + [(HERE, "this")] + others[::-1]
    for root, tag in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag],
                           cwd=root, capture_output=True, text=True, timeout=900)
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines), p.stderr.strip()[-800:] if p.returncode else "", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
