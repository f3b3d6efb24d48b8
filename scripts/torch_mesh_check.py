"""The port's multi-device serving path on every GPU of one host, over NCCL.

    python3 scripts/torch_mesh_check.py [--preset videoitg-8b] [--frames 512]
    python3 scripts/torch_mesh_check.py --cpu 4 --preset tiny --frames 8   # a gloo rehearsal

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
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="videoitg-8b")
    parser.add_argument("--frames", type=int, default=512)
    parser.add_argument("--cpu", type=int, default=0, metavar="N",
                        help="rehearse on N gloo ranks on the CPU (fp32) instead")
    args = parser.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.cpu:
        world, card = args.cpu, "cpu"
    else:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False; this script needs NVIDIA GPUs")
        world = torch.cuda.device_count()
        if world < 2:
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
    mp.start_processes(rank_main, args=(world, port, args), nprocs=world, start_method="spawn")
    print(card, flush=True)
    print(json.dumps({"ok": True, "ranks": world, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
