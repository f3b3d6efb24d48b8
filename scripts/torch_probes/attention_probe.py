"""Probe: the attention kernels A, B, K (serving) and C, D, E, J's dQ and
dK/dV (training) timed outside chip_smoke.py.

    python3 scripts/torch_probes/attention_probe.py --shapes
        A, B (online, Hq == Hkv, no mask) and scaled_dot_product_attention
        on one set of inputs at several shapes: what A's two walks cost
        against one, and what the head dim does to each.
    python3 scripts/torch_probes/attention_probe.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]
        A at [128, 16, 729, 72], B at [1, 28/4, 13056, 128] with and without
        its key mask, K (`splash_mqa`) on B's masked inputs as the splash arm
        hands them over (q pre-scaled, the mask as ids), and B causal at the
        VLM prefill's [1, 28/4, 15584, 128], in this checkout and in each
        other one (for example the parent commit unpacked by `git archive`
        into a directory .gitignore lists), in turns: others, this, this, the
        others in reverse.
    python3 scripts/torch_probes/attention_probe.py --train [OTHER_CHECKOUT ...]
        C, D and E at the grounding step's [1, 28/4, 16640, 128] with 16,500
        valid and causal at the VLM step's [1, 28/4, 16960, 128] (the packed
        layout's key mask), and J's dQ and dK/dV on the same tokens as the
        `train-jax` arm hands them over ([1, 28, 16896, 128] with 16,500 id-1
        tokens; causal [1, 28, 17408, 128]); E is timed first, right after D
        and right after J's dK/dV. In this checkout, in each other one and in
        variants of this checkout (a copy of videoitg_tpu_torch/ under
        build/attention_probe/ with constants of a csrc header changed: the
        grid order of E's and J's dK/dV instances), in turns: others, this,
        the variants, this, the others in reverse.
    python3 scripts/torch_probes/attention_probe.py --segment [OTHER_CHECKOUT ...]
        J's forward as the `train-jax` arm hands it over at its three shapes
        (the grounding step's [1, 28, 16896 padded from 16640, 128] with
        16,500 id-1 tokens, causal at the VLM step's [1, 28, 17408, 128], the
        tower's [32, 16, 1024 padded from 729, 72]) beside C on the same
        tokens (4 KV heads, the ids as key mask); K at [1, 28/4, 13056, 128]
        on prefix ids (12,840 valid) and on scattered ids (1% invalid) beside
        B on the same inputs. In this checkout, in each other one and in a
        variant with J's forward's grid order flipped (heads fastest), in
        the same turns as --train.

Each checkout runs in its own process, which builds its own library through
its ops/_build.py and prints ptxas' lines for the DP = 128 instances of
`hattn::stream_kernel` (and of `hattn::dkv_kernel` and `hattn::dq_kernel` with
--train) when it built it, and a hash of the machine code (cuobjdump -sass)
of every instance of A, B, C, D, E, K and J's forward, dQ and dK/dV
(`resident_kernel`, `stream_kernel`, `dq_kernel`, `dkv_kernel`); the last
lines say, instance by instance, whether each other checkout's hashes equal
this one's. Times: chip_smoke.py's CUDA-event timer, over 20 launches (10 for
B and K, 5 for C, 3 for D, E and J's dQ and dK/dV) after one warm-up; needs
one card. --segment times J's forward over 5 launches (20 at the tower's
shape), K and B over 30.

Read on an NVIDIA H100 80GB HBM3 at 700 W, ms:
  --shapes, with the first TMA version of A (K and V streamed in both
  passes): [128, 16, 729, 72] A 2.0968, B 1.5070, sdpa 1.0683; [.., 729, 80]
  A 1.6877, B 1.2344, sdpa 1.1013; with K resident: [128, 16, 729, 72] A
  1.4787, B 1.5044, sdpa 1.1228; [.., 729, 80] A 1.4544, B 1.2687.
  Against the step before (A with K streamed): A 2.0966 -> 1.4835 / 1.4852,
  B 5.2404 -> 5.2678 / 5.2388, B causal 4.6507 -> 3.8416 / 3.8112; with
  turn-taking between the warpgroups in A: 1.6000 / 1.6096.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANT_ROOT = os.path.join(HERE, "build", "attention_probe")
# tag -> (header under csrc/, {constant: value})
VARIANTS = {
    "--train": {
        "J dK/dV heads fastest": ("hopper_attention_dkv.cuh", {"kDkvKeyTilesFirstJ": 0}),
        "E key tiles fastest": ("hopper_attention_dkv.cuh", {"kDkvKeyTilesFirstE": 1}),
    },
    "--segment": {
        "J fwd heads fastest": ("hopper_attention_dkv.cuh", {"kFwdQueryTilesFirstJ": 0}),
    },
}
# The attention instances, by mangled name: the kernel, then its template
# arguments (DP, stream_kernel's two-pass and lse flags, the mask policy,
# the grid order of stream_kernel and dkv_kernel).
HASHED = re.compile(r"hattn\d+(resident_kernel|stream_kernel|dkv_kernel|dq_kernel)I(.+?)EEv")


def _smoke():
    """chip_smoke.py of this checkout, for its timer and ptxas parser."""
    path = os.path.join(HERE, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _smoke()
cuda_ms = smoke.cuda_ms


def kernels(root):
    sys.path.insert(0, root)
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

    return flash_mha_short, flash_mha


def shapes() -> None:
    import torch
    from torch.nn import functional as F

    flash_mha_short, flash_mha = kernels(HERE)
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(128, 16, 729, 72), (128, 16, 729, 80), (128, 16, 768, 80), (128, 16, 729, 128),
                  (16, 16, 4096, 72), (1, 28, 13056, 72), (128, 16, 1458, 72)]:
        q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        print(shape, "A %.4f" % cuda_ms(lambda: flash_mha_short(q, k, v), 20),
              "B-online %.4f" % cuda_ms(lambda: flash_mha(q, k, v), 20),
              "sdpa %.4f" % cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
              flush=True)


def instance_name(kernel: str, args: str) -> str:
    """'B DP 128', 'A two-pass DP 80', 'J dkv DP 128', ... from a mangled
    instance (the grid order is left out of the name)."""
    flags = re.findall(r"L[a-z]+(\d+)E", args)
    dp = flags[0]
    segment = "SegmentIds" in args
    if kernel == "resident_kernel":
        return f"A DP {dp}"
    if kernel == "dkv_kernel":
        return f"{'J dkv' if segment else 'E'} DP {dp}"
    if kernel == "dq_kernel":
        return f"{'J dq' if segment else 'D'} DP {dp}"
    if flags[1:2] == ["1"]:
        return f"A two-pass DP {dp}"
    if segment:
        return f"{'J fwd' if flags[2:3] == ['1'] else 'K'} DP {dp}"
    return f"{'C' if flags[2:3] == ['1'] else 'B'} DP {dp}"


def sass_hashes(lib_path: str, nvcc: str) -> dict:
    """instance -> (hash, instruction count) of each attention instance, from
    cuobjdump -sass; addresses and encodings are left out, so equal hashes
    mean the same instructions."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr.strip()[-300:]}")
    out, key, body = {}, None, []
    text = proc.stdout
    for line in text.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if key is not None:
                out[key] = (hashlib.sha256("\n".join(body).encode()).hexdigest()[:16], len(body))
            match = HASHED.search(line)
            key = instance_name(match.group(1), match.group(2)) if match else None
            body = []
            continue
        instr = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key is not None and instr:
            body.append(instr.group(1))
    return out


def code_report(tag: str, train: bool) -> None:
    """Builds this process's library; prints ptxas' lines and the hashes."""
    from videoitg_tpu_torch.ops import _build

    path = _build.build()
    _build.library()
    if _build.build_seconds is None:
        print(f"{tag}: cached build, no ptxas lines", flush=True)
    fragments = ("stream_kernelILi128E",) + (
        ("dkv_kernelILi128E", "dq_kernelILi128E") if train else ())
    for fragment in fragments:
        for line in smoke.ptxas_lines(_build.build_log, fragment):
            print(f"{tag}: ptxas {line}", flush=True)
    try:
        hashes = sass_hashes(path, _build.nvcc_path())
    except (OSError, RuntimeError) as exc:  # the timings below need no disassembler
        print(f"{tag}: no machine code hashes: {exc}", flush=True)
        return
    print(f"{tag}: machine code (sha256[:16] / instructions): "
          + ", ".join(f"{name}: {h} / {n}" for name, (h, n) in sorted(hashes.items())),
          flush=True)
    print("HASHES " + json.dumps({name: h for name, (h, _) in hashes.items()}), flush=True)


def one_checkout(tag: str) -> None:
    import torch

    flash_mha_short, flash_mha = kernels(os.getcwd())
    from videoitg_tpu_torch.ops import splash_attention as sa

    code_report(tag, train=False)
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*sh):
        return torch.randn(*sh, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = r(128, 16, 729, 72), r(128, 16, 729, 72), r(128, 16, 729, 72)
    a_ms = cuda_ms(lambda: flash_mha_short(q, k, v), 20)
    s = 13056
    q, k, v = r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128)
    valid = torch.rand(1, s, generator=g, device="cuda") > 0.01
    b_ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid), 10)
    qs, seg = sa.prescale(q), valid.to(torch.int32)
    k_ms = cuda_ms(lambda: sa.splash_mqa(qs, k, v, seg, seg), 10)
    del qs
    b_nomask = cuda_ms(lambda: flash_mha(q, k, v), 10)
    s = 15584
    q, k, v = r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128)
    valid = torch.ones(1, s, dtype=torch.bool, device="cuda")
    valid[0, 30:32] = False
    c_ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid, causal=True), 10)
    print(f"{tag}: A {a_ms:.4f} B {b_ms:.4f} K {k_ms:.4f} B-nomask {b_nomask:.4f} "
          f"B-causal {c_ms:.4f}", flush=True)


def one_checkout_train(tag: str) -> None:
    import torch

    sys.path.insert(0, os.getcwd())
    from videoitg_tpu_torch.ops import flash_attention_train as fat

    code_report(tag, train=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*sh):
        return torch.randn(*sh, generator=g, device="cuda").to(torch.bfloat16)

    s = 16640
    main = (r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128),
            (torch.arange(s, device="cuda") < 16500)[None].contiguous(), False)
    s = 64 + 16384 + 512
    pos = torch.arange(s, device="cuda")
    valid = ((pos < 30) | ((pos >= 64) & (pos < 64 + 16384 + 200)))[None].contiguous()
    causal = (r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128), valid, True)
    lines = []
    for what, (q, k, v, valid, is_causal) in (("", main), ("causal ", causal)):
        o, lse = fat.flash_train_fwd(q, k, v, valid, is_causal)
        do, delta = fat.prepare_backward(valid, o, r(*q.shape))

        def e():
            return cuda_ms(lambda: fat.flash_train_dkv(q, k, v, valid, do, lse, delta, is_causal),
                           3)

        # E first, right after D and right after J's dK/dV: E's time depends
        # on what ran before it.
        c_ms, e0 = cuda_ms(lambda: fat.flash_train_fwd(q, k, v, valid, is_causal), 5), e()
        d_ms = cuda_ms(lambda: fat.flash_train_dq(q, k, v, valid, do, lse, delta, is_causal), 3)
        e1 = e()
        jdq, jdkv = segment_times(r, q.shape[2], is_causal)
        e2 = e()
        lines.append(f"{what}C {c_ms:.4f} E {e0:.4f} D {d_ms:.4f} E-after-D {e1:.4f} "
                     f"J-dq {jdq:.4f} J-dkv {jdkv:.4f} E-after-J-dkv {e2:.4f}")
        del o, lse, do, delta
        torch.cuda.empty_cache()
    print(f"{tag}: " + "; ".join(lines), flush=True)


def segment_times(r, s, causal):
    """J's dQ and dK/dV as the `train-jax` arm calls them: 4 KV heads
    repeated to 28, S padded to a multiple of 512 with zeros in segment 0;
    non-causal with 16,500 id-1 tokens (the grounding step), causal with the
    VLM step's layout. Returns (dq ms, dkv ms)."""
    import torch

    from videoitg_tpu_torch.ops import flash_attention_segment as fas

    s_pad = -(-s // 512) * 512
    pos = torch.arange(s_pad, device="cuda")
    if causal:
        ids = (pos < 30) | ((pos >= 64) & (pos < 64 + 16384 + 200))
    else:
        ids = pos < 16500
    ids = ids.to(torch.int32)[None].contiguous()
    q = r(1, 28, s_pad, 128)
    k, v = (r(1, 4, s_pad, 128).repeat_interleave(7, dim=1) for _ in range(2))
    for x in (q, k, v):
        x[:, :, s:] = 0
    o, lse = fas.flash_segment_fwd(q, k, v, ids, ids, causal)
    do = r(1, 28, s_pad, 128)
    delta = fas.segment_delta(o, do)
    out = (cuda_ms(lambda: fas.flash_segment_dq(q, k, v, ids, ids, do, lse, delta, causal), 3),
           cuda_ms(lambda: fas.flash_segment_dkv(q, k, v, ids, ids, do, lse, delta, causal), 3))
    del q, k, v, o, lse, do, delta
    torch.cuda.empty_cache()
    return out


def one_checkout_segment(tag: str) -> None:
    import torch

    sys.path.insert(0, os.getcwd())
    from videoitg_tpu_torch.ops import flash_attention_segment as fas
    from videoitg_tpu_torch.ops import flash_attention_train as fat
    from videoitg_tpu_torch.ops import splash_attention as sa
    from videoitg_tpu_torch.ops.flash_attention import flash_mha

    code_report(tag, train=False)
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*sh):
        return torch.randn(*sh, generator=g, device="cuda").to(torch.bfloat16)

    lines = []
    for what, s, causal in (("", 16640, False), ("causal ", 64 + 16384 + 512, True)):
        s_pad = -(-s // 512) * 512
        pos = torch.arange(s_pad, device="cuda")
        if causal:
            ids = (pos < 30) | ((pos >= 64) & (pos < 64 + 16384 + 200))
        else:
            ids = pos < 16500
        ids = ids.to(torch.int32)[None].contiguous()
        q = r(1, 28, s_pad, 128)
        k, v = (r(1, 4, s_pad, 128) for _ in range(2))
        for x in (q, k, v):
            x[:, :, s:] = 0
        kr, vr = (x.repeat_interleave(7, dim=1) for x in (k, v))
        j_ms = cuda_ms(lambda: fas.flash_segment_fwd(q, kr, vr, ids, ids, causal), 5)
        del kr, vr
        qc, kc, vc = (x[:, :, :s].contiguous() for x in (q, k, v))
        valid = ids[:, :s].bool().contiguous()
        c_ms = cuda_ms(lambda: fat.flash_train_fwd(qc, kc, vc, valid, causal), 5)
        lines.append(f"{what}J-fwd {j_ms:.4f} C {c_ms:.4f}")
        del q, k, v, qc, kc, vc
        torch.cuda.empty_cache()
    q, k, v = (r(32, 16, 1024, 72) for _ in range(3))
    for x in (q, k, v):
        x[:, :, 729:] = 0
    ids = (torch.arange(1024, device="cuda")[None] < 729).to(torch.int32).expand(32, 1024)
    ids = ids.contiguous()
    lines.append("tower J-fwd %.4f" % cuda_ms(lambda: fas.flash_segment_fwd(q, k, v, ids, ids),
                                              20))
    s = 13056
    q, k, v = r(1, 28, s, 128), r(1, 4, s, 128), r(1, 4, s, 128)
    qs = sa.prescale(q)
    pos = torch.arange(s, device="cuda")[None]
    for what, valid in (("prefix", pos < 12840),
                        ("scattered", torch.rand(1, s, generator=g, device="cuda") > 0.01)):
        seg = valid.to(torch.int32).contiguous()
        k_ms = cuda_ms(lambda: sa.splash_mqa(qs, k, v, seg, seg), 30)
        b_ms = cuda_ms(lambda: flash_mha(q, k, v, valid=valid), 30)
        lines.append(f"K-{what} {k_ms:.4f} B-{what} {b_ms:.4f}")
    print(f"{tag}: " + "; ".join(lines), flush=True)


def variant(tag: str, header: str, change: dict) -> str:
    """A copy of this checkout's package with `change` applied to the
    constants of csrc/`header`."""
    root = os.path.join(VARIANT_ROOT, re.sub(r"[^A-Za-z0-9]+", "_", tag))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "videoitg_tpu_torch"),
                    os.path.join(root, "videoitg_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    header = os.path.join(root, "videoitg_tpu_torch", "csrc", header)
    with open(header) as f:
        text = f.read()
    for name, value in change.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{tag}: constant {name} not found in {header}")
    with open(header, "w") as f:
        f.write(text)
    return root


def main(argv) -> int:
    if argv[:1] == ["--shapes"]:
        shapes()
        return 0
    if argv[:1] == ["--one"]:
        runs = {"--train": one_checkout_train, "--segment": one_checkout_segment}
        runs.get(argv[2] if len(argv) > 2 else None, one_checkout)(argv[1])
        return 0
    mode = argv[:1] if argv[:1] in (["--train"], ["--segment"]) else []
    others = [(os.path.abspath(p), "other " + p) for p in argv[len(mode):]]
    if not others and not mode:
        raise SystemExit(__doc__)
    variants = VARIANTS.get(mode[0], {}) if mode else {}
    middle = [(variant(tag, *change), tag) for tag, change in variants.items()]
    order = others + [(HERE, "this")] + middle + [(HERE, "this")] + others[::-1]
    hashes = {}
    for root, tag in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag] + mode,
                           cwd=root, capture_output=True, text=True, timeout=900)
        lines = p.stdout.strip().splitlines()
        for line in lines:
            if line.startswith("HASHES "):
                hashes.setdefault(tag, json.loads(line[len("HASHES "):]))
        print("\n".join(x for x in lines if not x.startswith("HASHES ")),
              p.stderr.strip()[-500:], flush=True)
    mine = hashes.get("this", {})
    for tag, theirs in hashes.items():
        if tag == "this" or tag in variants:
            continue
        same = sum(theirs.get(n) == h for n, h in mine.items())
        differ = sorted(n for n in mine if n in theirs and theirs[n] != mine[n])
        missing = sorted(set(mine) - set(theirs))
        print(f"machine code, {tag} against this: {same} instances equal; differ: "
              f"{', '.join(differ) or 'none'}; only here: {', '.join(missing) or 'none'}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
