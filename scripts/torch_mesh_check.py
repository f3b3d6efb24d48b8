"""The port's multi-device serving and training paths on every GPU of one
host, over NCCL.

    python3 scripts/torch_mesh_check.py [--preset videoitg-8b] [--frames 512]
    python3 scripts/torch_mesh_check.py --cpu 4 --preset tiny --frames 8   # a gloo rehearsal
    python3 scripts/torch_mesh_check.py --train [--preset videoitg-8b] [--frames 1024]
    python3 scripts/torch_mesh_check.py --train --cpu 4 --preset tiny      # its rehearsal
    python3 scripts/torch_mesh_check.py --train    # on one card: tp's rounding alone

Spawns one process per visible GPU (torch.multiprocessing), opens a NCCL
group over tcp://localhost:<free port> with the rank and world size given
explicitly, and on the same random weights (seed 0, bf16) runs, per mesh
layout, `SelectionEngine(mesh=make_mesh(...))` against the engine with no
mesh on each rank:

* a `select` of one video, a `select_many` of 3 questions (dp splits them,
  padding the last group) and a `score_frames` batch of 3 videos (dp pads
  the batch), all ranks holding the same result;
* the act8 tier with kernel F (`VIDEOITG_QGEMM` on) at tp > 1: F on each
  rank's local columns or rows, the row-parallel linears quantising with the
  whole row's amax;
* the daemon (`cli/serve.SelectionServer` with the world group): rank 0
  decodes (the file reader swapped for seeded frames, as chip_smoke.py
  does), broadcasts each request and video over NCCL, every rank scores,
  rank 0 answers.

Prints, per layout and call, the largest score difference against the
no-mesh engine (held to chip_smoke.py's E2E_ATOL, 2e-2: the all-reduces
sum partial products in another order), whether the Top-K agree, the ranks'
agreement, the kernels' launches on rank 0, and the card's name and power
limit. It takes no time across devices. Needs at least 4 GPUs for every
layout; with 2 it runs the layouts that fit.

`--train` checks training instead: LoRA r16 over the bf16 base (fp32 on the
CPU), a batch of tower features as chip_smoke.py's training phase has it
(`--frames` frames a sample, 1024 by default: 16,640 LM tokens at
VideoITG-8B), one sample per dp rank, three `run_step(mesh=...)` calls on
each of the layouts dp4, tp4, sp4, dp2 x tp2, pp2 x dp2 and pp4 (those that
the ranks, the heads and the layers allow). Rank 0 first takes the same
three steps on its card with no mesh, for each batch size. Every rank's loss
and grad_norm must be within E2E_ATOL of the no-mesh run's, relative, and so
must the movement of its trainable leaves (LoRA and the scoring head, fp32:
the L1 size and the signed sum). A batch that does not fit one card leaves
its layouts unchecked, and says so. Each step is timed (wall, ending in a
device sync) and printed beside rank 0's C, D and E launches; a layout that
fails is named and the others still run. `--dtype` sets the weights' dtype (bf16 on the
cards, fp32 on the CPU by default): the rehearsal in both shows what bf16's rounding
alone moves between layouts, where fp32 layouts agree to rounding. The limit is
E2E_ATOL for every layout and dtype: tp sums its partials as GSPMD does on the JAX
package's CPU mesh (bf16 partial products rounded once, summed in fp32; a row-parallel
adapter's x @ a summed before @ b; parallel/tensor.py), and the bf16 rehearsal
(`--train --cpu 4 --preset dryrun --dtype bfloat16`) then moves tp4 by 0.28% and
dp2 x tp2 by 0.15% after the first update, where rounding each rank's partial adapter
delta into its bf16 partial product moved them by 6.88% and 2.09%.
tests/test_torch_parallel_train_tp_bf16.py holds both packages' bf16 tp gaps side
by side.

`--train` on one device, where no layout fits, runs the no-mesh steps of
batch 1 and a witness that needs no second card: the same steps again with the linears
that tp splits computed as tp = 1, 2 and 4 ranks compute them (a column-parallel linear
in n column blocks whose n partial input gradients are summed in fp32; a row-parallel
one as n partial products, each rounded to the output's dtype and summed in fp32, the
adapter's x @ a summed over the n row blocks before @ b), each beside the plain steps.
tp = 1 must equal the plain steps bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_ATOL = 2e-2
QUESTIONS = ["What is the person holding?", "When does the car turn left?",
             "Which scene shows the rocket launch?"]
# name -> (make_mesh kwargs, ranks it needs)
LAYOUTS = {
    "dp2": (dict(dp=2, tp=1), 2),
    "tp2": (dict(dp=1, tp=2), 2),
    "sp2": (dict(dp=1, tp=1, sp=2), 2),
    "pp2": (dict(dp=1, tp=1, pp=2), 2),
    "dp2-tp2": (dict(dp=2, tp=2), 4),
    "tp4": (dict(dp=1, tp=4), 4),
    "tp2-sp2": (dict(dp=1, tp=2, sp=2), 4),
    "pp2-tp2": (dict(pp=2, dp=1, tp=2), 4),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def _frames(seed: int, t: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (t, 360, 640, 3), dtype=np.uint8)


def _calls(engine, n_frames: int) -> dict:
    sampled = list(range(n_frames))
    sel = engine.select(_frames(1, n_frames), sampled, QUESTIONS[0])
    many = engine.select_many(_frames(2, n_frames), sampled, QUESTIONS)
    batch = engine.score_frames([_frames(3 + i, n_frames // 4) for i in range(3)], QUESTIONS)
    return {"select": [sel.raw_scores], "select_many": [r.raw_scores for r in many],
            "score_frames": batch}


def _compare(tag, got, want, gather, rank):
    """Largest score difference and Top-K agreement of one call; every rank
    must hold the same scores."""
    import numpy as np
    import torch

    diff, same_top = 0.0, True
    for g, w in zip(got, want):
        diff = max(diff, float(np.abs(g - w).max()))
        k = min(32, len(w))
        same_top &= sorted(np.argsort(-g, kind="stable")[:k].tolist()) == \
            sorted(np.argsort(-w, kind="stable")[:k].tolist())
    mine = torch.tensor(np.concatenate(got), device=gather.device)
    ranks = gather(mine)
    agree = all(torch.equal(r, ranks[0]) for r in ranks)
    if rank == 0:
        print(f"  {tag}: max |score diff| {diff:.6g} (atol {E2E_ATOL}), top-32 equal "
              f"{same_top}, ranks agree {agree}", flush=True)
    if not diff <= E2E_ATOL or not agree:
        fail(f"{tag}: diff {diff}, ranks agree {agree}")


def _serve(engine, plain, n_frames: int, rank: int):
    """The daemon on the world group: rank 0 submits two requests (a miss
    and an LRU hit), the others follow. Returns rank 0's answers next to
    the no-mesh engine's scores of the same frames."""
    import threading

    import torch.distributed as dist

    from videoitg_tpu_torch.cli import serve
    from videoitg_tpu_torch.data import video as video_mod

    frames = _frames(9, n_frames)
    sampled = list(range(0, 3 * n_frames, 3))

    def reader(path, num_frames=512, target_fps=1.0, sampling="eval", multiple=1, pix_fmt="rgb"):
        if rank != 0:
            raise RuntimeError("a follower rank read a video file")
        return frames, list(sampled)

    video_mod.read_video_frames = reader
    server = serve.SelectionServer(engine, group=dist.group.WORLD)
    if not server.leader:
        server.follow()
        server.close()
        return None
    out = []

    def ask():
        for prompt in QUESTIONS[:2]:
            out.append(server.submit({"video_path": "/videos/a.mp4", "prompt": prompt,
                                      "topk": 32}))

    t = threading.Thread(target=ask)
    t.start()
    t.join()
    server.close()
    want = plain.select_many(frames, sampled, QUESTIONS[:2])
    return out, want


def rank_main(rank: int, world: int, port: int, args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    if args.cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.ops import flash_attention, flash_attention_short, quant_gemm
    from videoitg_tpu_torch.ops import flash_attention_train
    from videoitg_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    dtype = torch.float32 if args.cpu else torch.bfloat16
    counted = {"A": flash_attention_short.flash_mha_short, "B": flash_attention.flash_mha,
               "C": flash_attention_train.flash_train_fwd, "F": quant_gemm.act8_gemm}

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return parts
    gather.device = dev

    t0 = time.perf_counter()
    model, cfg, tok = load_grounding_components(None, args.preset, True, dtype, dev,
                                                seed=0)
    plain = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype)
    want = _calls(plain, args.frames)
    if rank == 0:
        print(f"{args.preset} bf16 on {world} ranks (NCCL): weights and the no-mesh calls in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (kw, need) in LAYOUTS.items():
        if need > world:
            continue
        mesh = make_mesh(ranks=list(range(need)), **kw)
        # the layout's ranks compare among themselves (every rank creates the group)
        group = dist.new_group(list(range(need))) if need < world else dist.group.WORLD
        if mesh.get_coordinate() is not None:
            engine = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype,
                                     mesh=mesh)
            for fn in counted.values():
                fn.launches = 0
            got = _calls(engine, args.frames)
            if rank == 0:
                print(f"layout {name} {mesh_shape(mesh)}: launches on rank 0 over its 5 LM "
                      f"passes {({k: fn.launches for k, fn in counted.items()})}", flush=True)
            del engine
        dist.barrier()
        if mesh.get_coordinate() is None:
            continue

        def gather_in(x, group=group, need=need):
            parts = [torch.empty_like(x) for _ in range(need)]
            dist.all_gather(parts, x, group=group)
            return parts
        gather_in.device = dev
        for call in ("select", "select_many", "score_frames"):
            _compare(f"{name} {call}", got[call], want[call], gather_in, rank)
    dist.barrier()

    # act8 with kernel F at tp 2, against the no-mesh act8 engine
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier

    apply_quantization_tier(model, "act8")
    act8_plain = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype, qgemm=True)
    want8 = _calls(act8_plain, args.frames)
    mesh = make_mesh(dp=world // 2, tp=2)
    engine = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype, mesh=mesh,
                             qgemm=True)
    quant_gemm.act8_gemm.launches = 0
    got8 = _calls(engine, args.frames)
    if rank == 0:
        print(f"act8 {mesh_shape(mesh)} with kernel F: F launches on rank 0 "
              f"{quant_gemm.act8_gemm.launches}", flush=True)
    if not args.cpu and quant_gemm.act8_gemm.launches <= 0:  # the CPU runs F's plain version
        fail("kernel F never launched at tp=2")
    for call in ("select", "select_many", "score_frames"):
        _compare(f"act8 tp2 {call}", got8[call], want8[call], gather, rank)
    del engine, act8_plain
    dist.barrier()

    # the daemon over the world group, on the dp x tp bf16 engine
    model, cfg, tok = load_grounding_components(None, args.preset, True, dtype, dev,
                                                seed=0)
    plain = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype)
    engine = SelectionEngine(model, cfg, tok, device=dev, dtype=dtype,
                             mesh=make_mesh(dp=world // 2, tp=2))
    served = _serve(engine, plain, args.frames, rank)
    if rank == 0:
        out, ref = served
        errors = [o["error"] for o in out if "error" in o]
        if errors:
            fail(f"daemon: {errors}")
        for o, r in zip(out, ref):
            diff = float(np.abs(np.asarray(o["logits"]) - np.sort(r.raw_scores)[::-1]).max())
            print(f"  daemon {o['contexts']!r}: top-8 {o['selected'][:8]}, max |2-dp logit - "
                  f"score| {diff:.6g}, no-mesh top-8 {r.topk(32)[:8]}", flush=True)
            if not diff <= E2E_ATOL + 0.005:
                fail(f"daemon answer off by {diff}")
    dist.barrier()
    dist.destroy_process_group()


TRAIN_LAYOUTS = {
    "dp4": (dict(dp=4, tp=1), 4),
    "tp4": (dict(dp=1, tp=4), 4),
    "sp4": (dict(dp=1, tp=1, sp=4), 4),
    "dp2-tp2": (dict(dp=2, tp=2), 4),
    "pp2-dp2": (dict(pp=2, dp=2, tp=1), 4),
    "pp4": (dict(pp=4, dp=1, tp=1), 4),
    # what fits two ranks
    "dp2": (dict(dp=2, tp=1), 2),
    "tp2": (dict(dp=1, tp=2), 2),
    "sp2": (dict(dp=1, tp=1, sp=2), 2),
    "pp2": (dict(pp=2, dp=1, tp=1), 2),
}
TRAIN_STEPS = 3


def _fits(kw, cfg, tokens) -> bool:
    tp, pp, sp = kw.get("tp", 1), kw.get("pp", 1), kw.get("sp", 1)
    return (cfg.lm.num_kv_heads % tp == 0 and cfg.vision.num_heads % tp == 0
            and cfg.lm.num_layers % pp == 0 and tokens % sp == 0)


def _train_batch(cfg, n, frames, dtype, dev):
    """n samples of tower features (one per dp rank), seeded."""
    import torch

    from videoitg_tpu_torch.models.grounding import GroundingBatch

    gen = torch.Generator(device=dev).manual_seed(31)
    return GroundingBatch(
        frames=torch.randn(n, frames, cfg.vision.num_patches, cfg.vision.hidden_size,
                           generator=gen, device=dev).to(dtype),
        frame_valid=torch.ones(n, frames, dtype=torch.bool, device=dev),
        text_ids=torch.randint(0, cfg.lm.vocab_size, (n, cfg.max_text_len), generator=gen,
                               device=dev),
        text_valid=torch.arange(cfg.max_text_len, device=dev)[None].expand(n, -1) < 40,
        labels=(torch.rand(n, frames, generator=gen, device=dev) < 0.1).float())


def _steps(model, cfg, batch, hw, use_flash, dev, start, mesh=None):
    """TRAIN_STEPS steps of LoRA training: ([(loss, grad_norm, wall s)],
    {name in the whole model: (sum, sum of |.|) of the trainable leaf's
    movement from `start`, fp64})."""
    import torch

    from videoitg_tpu_torch.train.lora import make_lora_optimizer
    from videoitg_tpu_torch.train.train_step import create_train_state, make_train_step, run_step

    tx = make_lora_optimizer(model, learning_rate=2e-4, out_proj_lr=2e-4, total_steps=10)
    state = create_train_state(model, tx)
    step_fn = make_train_step(cfg, tx, hw=hw, use_flash=use_flash, remat=True)
    out = []
    for _ in range(TRAIN_STEPS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run_step(step_fn, state, batch, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]), time.perf_counter() - t0))
    stage = getattr(model.lm, "pp_layers", None)
    sums = {}
    for name, p in zip(tx.trainable_names(), tx.params):
        if stage is not None and name.startswith("lm.layers."):
            _, _, idx, rest = name.split(".", 3)
            name = f"lm.layers.{stage[0] + int(idx)}.{rest}"
        delta = p.detach().double() - start[name].double()
        sums[name] = (float(delta.sum()), float(delta.abs().sum()))
    return out, sums


def _rounded_linear(p, x, act8=None):
    """A linear marked by `_tp_rounding`, on one device, rounded as its
    `tp.size` ranks round it (no collective): a row-parallel one as n partial
    products, each rounded to the output's dtype and summed in fp32, the
    adapter's x @ a summed over the n row blocks before @ b; a
    column-parallel one in n column blocks whose n partial input gradients
    are summed in fp32 (parallel/tensor.py)."""
    from videoitg_tpu_torch.parallel.tensor import _lora, _lora_tail

    n = p.tp.size
    if p.tp.kind == "row":
        step = p.w.shape[0] // n
        rows = [slice(r * step, (r + 1) * step) for r in range(n)]
        y = sum((x[..., r] @ p.w[r]).float() for r in rows).to(x.dtype)
        if p.lora_a is not None:
            h = sum(x[..., r].to(p.lora_a.dtype) @ p.lora_a[r] for r in rows)
            y = y + _lora_tail(h, p.lora_b, p.lora_scale).to(y.dtype)
    else:
        step = p.w.shape[1] // n
        parts = []
        # tp = 1 splits nothing: x as it is, its gradients accumulated as with no mesh
        for r, xr in enumerate((x,) if n == 1 else _Replicas.apply(x, n)):
            cols = slice(r * step, (r + 1) * step)
            part = xr @ p.w[:, cols]
            if p.lora_a is not None:
                part = part + _lora(xr, p.lora_a, p.lora_b[:, cols], p.lora_scale).to(part.dtype)
            parts.append(part)
        y = torch.cat(parts, dim=-1)
    if p.b is not None:
        y = y + p.b
    return y


class _Replicas(torch.autograd.Function):
    """n views of x whose gradients are summed in fp32 (`copy_to_tp`'s
    backward over n ranks)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return sum(g.float() for g in grads).to(grads[0].dtype), None


class _tp_rounding:
    """Within it, the dense linears of `model` that `shard_model` splits over
    tp run through `_rounded_linear` as tp = n would round them."""

    def __init__(self, model, n: int):
        self.model, self.n = model, n

    def __enter__(self):
        from videoitg_tpu_torch.models.common import Linear
        from videoitg_tpu_torch.parallel import sharding, tensor
        from videoitg_tpu_torch.parallel.mesh import TP_AXIS

        specs = sharding.adapt_specs_to_params(sharding.grounding_param_specs(), self.model)
        self.marked = []
        for name, mod in self.model.named_modules():
            spec = specs.get(f"{name}.w")
            if isinstance(mod, Linear) and spec in ((None, TP_AXIS), (TP_AXIS, None)):
                mod.tp = sharding.TPShard("col" if spec[1] == TP_AXIS else "row", 0, self.n)
                self.marked.append(mod)
        self.tensor, self.saved = tensor, tensor.tp_linear
        tensor.tp_linear = _rounded_linear
        return self

    def __exit__(self, *exc):
        self.tensor.tp_linear = self.saved
        for mod in self.marked:
            del mod.tp


def rank_train(rank: int, world: int, port: int, args) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    if args.cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.ops import flash_attention_train as fat
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.mesh import make_mesh, mesh_coords, mesh_shape
    from videoitg_tpu_torch.train.lora import add_lora

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        args.dtype or ("float32" if args.cpu else "bfloat16")]
    frames = args.frames or (16 if args.cpu else 1024)
    t0 = time.perf_counter()
    model, cfg, _ = load_grounding_components(None, args.preset, True, dtype, dev, seed=0)
    add_lora(model, torch.Generator(device=dev).manual_seed(1), rank=16)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    hw = cfg.projector.tokens_hw(frames, cfg.vision.num_patches_per_side)
    tokens = frames * hw * hw + cfg.max_text_len
    use_flash = True  # the training kernels; on the CPU their plain versions (sp rings there too)
    need = min(world, 4)  # the layouts' ranks: the first `need` (every rank makes the mesh)
    layouts = {name: kw for name, (kw, n) in TRAIN_LAYOUTS.items()
               if n == need and _fits(kw, cfg, tokens)}
    if rank == 0:
        skipped = [n for n, (kw, k) in TRAIN_LAYOUTS.items() if k == need and n not in layouts]
        print(f"{args.preset} {str(dtype)[6:]} + LoRA r16 on {world} ranks: {frames} frames a "
              f"sample, hw {hw}, {tokens} LM tokens; layouts {list(layouts)}"
              f"{f', not fitting {skipped}' if skipped else ''}; weights in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    def restart():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])

    # the no-mesh reference on rank 0's card, for every batch size
    ref = {}
    if rank == 0:
        # one rank: only the reference, at batch 1
        for n in sorted({kw.get("dp", 1) for kw in layouts.values()}) or [1]:
            restart()
            try:
                ref[n] = _steps(model, cfg, _train_batch(cfg, n, frames, dtype, dev), hw,
                                use_flash, dev, start)
            except torch.cuda.OutOfMemoryError:
                ref[n] = None
                torch.cuda.empty_cache()
                print(f"no mesh, batch {n}: does not fit one card; the layouts with dp={n} "
                      f"are not checked", flush=True)
                continue
            print(f"no mesh, batch {n}: (loss, grad_norm, s) per step "
                  f"{[tuple(round(x, 6) for x in r) for r in ref[n][0]]}", flush=True)
    if world == 1 and ref.get(1) is not None:  # no layout to check: tp's rounding instead
        want, want_sums = ref[1]
        batch = _train_batch(cfg, 1, frames, dtype, dev)
        for n in (1, 2, 4):
            if not _fits({"tp": n}, cfg, tokens):
                continue
            restart()
            with _tp_rounding(model, n):
                got, sums = _steps(model, cfg, batch, hw, use_flash, dev, start)
            gaps = [(_rel(loss, wl), _rel(norm, wn))
                    for (loss, norm, _), (wl, wn, _) in zip(got, want)]
            leaves = _leaf_diff(sums, want_sums)
            print(f"tp rounding {n} on one device: (loss, grad_norm, s) per step "
                  f"{[tuple(round(x, 6) for x in r) for r in got]}; relative loss / "
                  f"grad_norm difference from the plain steps per step "
                  f"{[f'{a:.3g} / {b:.3g}' for a, b in gaps]}, of the leaves' movement "
                  f"{leaves:.3g}", flush=True)
            if n == 1 and (any(a or b for a, b in gaps) or leaves):
                fail("tp rounding 1 differs from the plain steps")
    missing = [[n for n, r in ref.items() if r is None]] if rank == 0 else [None]
    dist.broadcast_object_list(missing, src=0)
    layouts = {name: kw for name, kw in layouts.items() if kw.get("dp", 1) not in missing[0]}
    dist.barrier()
    failed = []
    for name, kw in layouts.items():
        restart()
        mesh = make_mesh(ranks=list(range(need)), **kw)
        shape = mesh_shape(mesh)
        mine = None
        if mesh.get_coordinate() is not None:
            tp_group = mesh.get_group("tp") if shape.get("tp", 1) > 1 else None
            local = sharding.shard_model(model, sharding.grounding_param_specs(
                pp=shape.get("pp", 1) > 1), shape, mesh_coords(mesh), tp_group=tp_group)
            batch = _train_batch(cfg, shape.get("dp", 1), frames, dtype, dev)
            for fn in (fat.flash_train_fwd, fat.flash_train_dq, fat.flash_train_dkv):
                fn.launches = 0
            got = _steps(local, cfg, batch, hw, use_flash, dev, start, mesh=mesh)
            launches = [fn.launches // TRAIN_STEPS
                        for fn in (fat.flash_train_fwd, fat.flash_train_dq, fat.flash_train_dkv)]
            mine = (mesh_coords(mesh), got, launches)
            del local, batch
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        gathered = [g for g in gathered if g is not None]
        if rank != 0:
            continue
        want, want_sums = ref[shape.get("dp", 1)]
        worst, worst_leaves = [0.0] * TRAIN_STEPS, 0.0
        for _, (steps, sums), _ in gathered:
            for i, ((loss, norm, _), (wl, wn, _)) in enumerate(zip(steps, want)):
                worst[i] = max(worst[i], _rel(loss, wl), _rel(norm, wn))
            worst_leaves = max(worst_leaves, _leaf_diff(sums, want_sums))
        ok = max(worst) <= E2E_ATOL and worst_leaves <= E2E_ATOL
        steps0 = gathered[0][1][0]
        print(f"train {name} {shape}: rank 0 (loss, grad_norm, s) per step "
              f"{[tuple(round(x, 6) for x in r) for r in steps0]}; worst relative loss / "
              f"grad_norm difference over the ranks per step {[f'{w:.3g}' for w in worst]}, "
              f"of the leaves' movement {worst_leaves:.3g} (tol {E2E_ATOL}); rank 0's C, D, E "
              f"launches a step {gathered[0][2]}{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            failed.append(name)
    dist.barrier()
    dist.destroy_process_group()
    if failed:
        fail(f"train layouts {failed} differ from one card with no mesh")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _leaf_diff(sums, want) -> float:
    """How far one run's movement of the trainable leaves is from another's,
    over the leaves of `sums` (a rank's): the larger of the difference of
    their L1 sizes and of their signed sums, relative to `want`'s L1 size."""
    l1, l1_want = (sum(x[k][1] for k in sums) for x in (sums, want))
    signed = abs(sum(sums[k][0] - want[k][0] for k in sums))
    return max(abs(l1 - l1_want), signed) / l1_want


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="videoitg-8b")
    parser.add_argument("--frames", type=int, default=None,
                        help="frames a video (default 512) or, with --train, a training "
                             "sample (default 1024 on the cards, 16 on the CPU)")
    parser.add_argument("--cpu", type=int, default=0, metavar="N",
                        help="rehearse on N gloo ranks on the CPU (fp32) instead")
    parser.add_argument("--train", action="store_true",
                        help="check training steps on the layouts instead of serving")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                        help="with --train: the weights' dtype (default bfloat16 on the "
                             "cards, float32 on the CPU)")
    args = parser.parse_args(argv)
    if args.frames is None and not args.train:
        args.frames = 512
    import torch
    import torch.multiprocessing as mp

    if args.cpu:
        world, card = args.cpu, "cpu"
    else:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False; this script needs NVIDIA GPUs")
        world = torch.cuda.device_count()
        if world < 2 and not args.train:
            fail(f"{world} GPU: the mesh check needs at least 2")
        card = card_line()
        from videoitg_tpu_torch.ops import _build

        _build.library()  # built once, before the ranks start
    print(f"card {card}; {world} ranks; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.start_processes(rank_train if args.train else rank_main, args=(world, port, args),
                       nprocs=world, start_method="spawn")
    print(card, flush=True)
    print(json.dumps({"ok": True, "ranks": world, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
