"""Probe: the int8 kernels F (`act8_gemm`), G (`fused_ln_qkv_int8`), H
(`fused_ln_mlp_int8`) and I (`fused_proj_residual_int8`) timed outside
chip_smoke.py, in this checkout, in variants of it and in other checkouts,
with a hash of each int8 instance's machine code.

    python3 scripts/torch_probes/int8_gemm_probe.py [OTHER_CHECKOUT ...]

F as `act8_linear` calls it (the row scale made, then the product) at the
LM's four shapes, M = 13,056 tokens: (K, N) = (3584, 3584), (3584, 512),
(3584, 18944), (18944, 3584), and the 7 launches of one layer; G, H
(gelu_tanh, via 4304) and I at the tower's [93,312, 1152], whole and, where
the checkout has them, launch by launch. Each result is held to its plain
version (F: error in bf16 ulps of max|ref|; G, H, I: error over
chip_smoke.py's `int8_tol`). The variants are copies of this checkout's
package under build/int8_gemm_probe/ with constants of a csrc file changed
(VARIANTS). Order: others, this, the variants, this, the others in
reverse; each checkout in its own process with its own build. Each process
also hashes the machine code (cuobjdump -sass, instructions without
addresses or encodings) of every int8 instance (the GEMM's instances by
policy, the row quantisers, the mma.sync kernels where a checkout has them);
the last lines say, instance by instance, whether each other checkout's
hashes equal this one's. Needs one card. Times: chip_smoke.py's CUDA-event
timer, 10 launches of F (5 of G, H and I) after one warm-up.
"""

from __future__ import annotations

import hashlib
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
# Mangled-name fragment -> the instance's name in the hash report, first
# match wins. H's fc2 is `BiasResidual` in older checkouts and
# `BiasResidual<ScaleOfAmax>` since I shares the policy: one name for both.
INSTANCES = (
    ("row_quant_kernel", "row_quant_kernel (F, I)"),
    ("ln_quant_kernel", "ln_quant_kernel (G, H)"),
    ("7Act8Out", "F Act8Out"),
    ("6QkvOut", "G QkvOut"),
    ("7RowAmaxILi0E", "H RowAmax<0>"),
    ("7RowAmaxILi1E", "H RowAmax<1>"),
    ("10QuantStoreILi0E", "H QuantStore<0>"),
    ("10QuantStoreILi1E", "H QuantStore<1>"),
    ("10ScaleGiven", "I BiasResidual<ScaleGiven>"),
    ("12BiasResidual", "H BiasResidual"),
    ("ln_qkv_kernel", "G ln_qkv_kernel (mma.sync)"),
    ("proj_res_kernel", "I proj_res_kernel (mma.sync)"),
)
TOKENS = 512 * 25 + 256
ROWS, WIDTH, INTER = 128 * 729, 1152, 4304


def _smoke():
    """chip_smoke.py of this checkout, for its timer and tolerances."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_hashes(lib_path: str, nvcc: str) -> dict:
    """instance -> hash of the int8 instances' instructions (cuobjdump -sass,
    addresses and encodings left out, so equal hashes mean the same
    instructions)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr.strip()[-300:]}")
    out, key, body = {}, None, []
    for line in proc.stdout.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if key is not None:
                out[key] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
            key = next((name for frag, name in INSTANCES if frag in line), None)
            body = []
            continue
        instr = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key is not None and instr:
            body.append(instr.group(1))
    return out


def one_checkout(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    from videoitg_tpu_torch.models.common import Linear, Norm
    from videoitg_tpu_torch.ops import _build
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

    try:
        print("HASHES " + json.dumps(sass_hashes(_build.build(), _build.nvcc_path())), flush=True)
    except (OSError, RuntimeError) as exc:  # the timings below need no disassembler
        print(f"{tag}: no machine code hashes: {exc}", flush=True)
    out = {"tag": tag, "f": {}, "g": {}, "h": {}, "i": {}}
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
    # LN + quantise: `ln_row_quant`, H's own `mlp_ln_quant` in older checkouts
    ln_quant = getattr(fe, "ln_row_quant", None) or getattr(fe, "mlp_ln_quant", None)
    if ln_quant is not None:
        yq, ys = ln_quant(x, ln, eps)
        amax = fe.mlp_fc1_amax(yq, ys, fc1, act)
        gq = fe.mlp_fc1_quant(yq, ys, fc1, amax, act)
        out["h"]["launches_ms"] = [
            smoke.cuda_ms(lambda: ln_quant(x, ln, eps), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc1_amax(yq, ys, fc1, act), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc1_quant(yq, ys, fc1, amax, act), 5),
            smoke.cuda_ms(lambda: fe.mlp_fc2_residual(x, gq, amax, fc2), 5)]
        del yq, ys, amax, gq
    del got, ref, fc1, fc2

    lins = [int8_linear(WIDTH, WIDTH, bias_std=0.5) for _ in range(4)]
    got = fe.fused_ln_qkv_int8(x, ln, *lins[:3], eps)
    ref = fe.fused_ln_qkv_int8_reference(x, ln, *lins[:3], eps)
    out["g"]["err_over_tol"] = max((g.float() - r.float()).abs().max().item()
                                   / smoke.int8_tol(r.float()) for g, r in zip(got, ref))
    out["g"]["ms"] = smoke.cuda_ms(lambda: fe.fused_ln_qkv_int8(x, ln, *lins[:3], eps), 5)
    if hasattr(fe, "qkv_project"):
        yq, ys = fe.ln_row_quant(x, ln, eps)
        out["g"]["launches_ms"] = [smoke.cuda_ms(lambda: fe.ln_row_quant(x, ln, eps), 5),
                                   smoke.cuda_ms(lambda: fe.qkv_project(yq, ys, *lins[:3]), 5)]
        del yq, ys
    del got, ref
    attn = torch.randn(ROWS, WIDTH, generator=gen, device=dev).to(torch.bfloat16)
    got = fe.fused_proj_residual_int8(attn, x, lins[3])
    ref = fe.fused_proj_residual_int8_reference(attn, x, lins[3])
    out["i"]["err_over_tol"] = (got.float() - ref.float()).abs().max().item() / smoke.int8_tol(
        ref.float())
    out["i"]["bit_equal"] = bool(torch.equal(got, ref))
    out["i"]["ms"] = smoke.cuda_ms(lambda: fe.fused_proj_residual_int8(attn, x, lins[3]), 5)
    if hasattr(fe, "proj_residual"):
        aq, a_scale = qg.row_quant_int8(attn)
        out["i"]["launches_ms"] = [
            smoke.cuda_ms(lambda: qg.row_quant_int8(attn), 5),
            smoke.cuda_ms(lambda: fe.proj_residual(aq, a_scale, x, lins[3]), 5)]
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
    hashes = {}
    for root, tag in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag],
                           cwd=root, capture_output=True, text=True, timeout=900)
        lines = p.stdout.strip().splitlines()
        for line in lines:
            if line.startswith("HASHES "):
                hashes.setdefault(tag, json.loads(line[len("HASHES "):]))
        print("\n".join(x for x in lines if not x.startswith("HASHES ")),
              p.stderr.strip()[-800:] if p.returncode else "", flush=True)
    mine = hashes.get("this", {})
    print("machine code, this checkout: " + ", ".join(f"{n}: {h}" for n, h in sorted(
        mine.items())), flush=True)
    for tag, theirs in hashes.items():
        if tag == "this" or tag in VARIANTS:
            continue
        same = sorted(n for n in mine if theirs.get(n) == mine[n])
        differ = sorted(n for n in mine if n in theirs and theirs[n] != mine[n])
        print(f"machine code, {tag} against this: equal: {', '.join(same) or 'none'}; differ: "
              f"{', '.join(differ) or 'none'}; only here: "
              f"{', '.join(sorted(set(mine) - set(theirs))) or 'none'}; only there: "
              f"{', '.join(sorted(set(theirs) - set(mine))) or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
