"""Training that learns, on the PyTorch port: the 2B tier overfits a
synthetic 32-video grounding set until Top-1 selected-frame accuracy on the
training set passes a threshold, with one SIGKILL in the middle of the run
and an auto-resume.

The port's counterpart of scripts/train/overfit_smoke.py, function for
function. One loop exercises what step-level tests cannot: the learning-rate
groups (out_proj at 10x), cosine with warmup, BCE pos_weight, the checkpoint
cadence and resume after a kill.

Task: video i carries its grounding label at frame (i % targets) and the
instruction "find clip {i % targets}": the question's tokens say which frame
is the target, so the model must couple text to frame scores, which a
random-init stack learns in a few hundred steps. A budget of 128 vision
tokens with a minimum hw of 2 pins hw at 2 for 32 frames.

Phase 1 runs `python -m videoitg_tpu_torch.cli.train` in a child process,
waits for the checkpoint at or past --save-steps, lets it run --kill-after
seconds more and sends SIGKILL. Phase 2 runs the same command, which must
print "[train] auto-resumed from step N" and finish. Then the newest
checkpoint is restored into the template the CLI builds (same seeds, same
optimizer groups) and a SelectionEngine (32 frames, 10 fps, one bucket)
scores every training video through `select_from_file`.

Usage (on the card; --cpu for the CPU):
    python scripts/train/torch_overfit_smoke.py --lora 16 --steps 400 --batch 2 --lr 2e-4
    python scripts/train/torch_overfit_smoke.py --preset tiny --cpu --videos 4 --steps 30 \\
        --save-steps 5 --lora 4 --kill-after 0 --threshold 0
    (bash scripts/train/torch_overfit_smoke.sh wraps this)

The last line is a JSON object: top1_train_accuracy, steps, videos,
killed_at_step, pass. The exit code is 1 below --threshold.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_FRAMES = 32
FPS = 10
BUDGET, MIN_HW = 128, 2   # hw = floor(sqrt(128 / 32)) = 2 = min -> pinned
SEED = 7
TRAIN_CLI = [sys.executable, "-m", "videoitg_tpu_torch.cli.train"]
PHASE1_DEADLINE_S = 40 * 60


def build_data(workdir: str, n_videos: int, targets: int) -> str:
    """`n_videos` solid-colour fixtures of N_FRAMES frames and the grounding
    records over them; returns the records' path."""
    from videoitg_tpu_torch.data.video import write_test_video

    vids = os.path.join(workdir, "vids")
    os.makedirs(vids, exist_ok=True)
    records = []
    for i in range(n_videos):
        write_test_video(os.path.join(vids, f"v{i}.mp4"), 64, 48, N_FRAMES, FPS, 8)
        j = i % targets
        records.append({"video": f"vids/v{i}.mp4", "question": f"find clip {j}",
                        "clip_num": [j]})
    data = os.path.join(workdir, "ground.json")
    with open(data, "w") as f:
        json.dump(records, f)
    return data


def train_cmd(workdir: str, data: str, out_dir: str, steps: int, lr: float, save_steps: int,
              batch: int = 2, lora: int = 0, preset: str = "videoitg-2b", cpu: bool = False,
              launcher=TRAIN_CLI) -> list:
    """The training command: `launcher` (the port's train CLI) with the JAX
    script's flags."""
    extra = ["--lora", str(lora)] if lora else []
    if cpu:
        extra.append("--cpu")
    return list(launcher) + [
        "--preset", preset, "--random-init",
        "--data-path", data, "--image-folder", workdir,
        "--video-frames", str(N_FRAMES), "--fps", str(FPS),
        "--vision-token-num", str(BUDGET), "--vision-min-num", str(MIN_HW),
        "--learning-rate", str(lr), "--out-proj-lr", str(lr * 10),
        "--warmup-ratio", "0.03", "--lr-scheduler-type", "cosine",
        "--total-steps", str(steps), "--save-steps", str(save_steps),
        "--per-device-train-batch-size", str(batch),
        "--num-train-epochs", "1000",  # cycle the videos until total-steps
        "--output-dir", out_dir, "--logging-steps", "5", "--seed", str(SEED),
    ] + extra


def run_phase1_with_kill(cmd, out_dir: str, save_steps: int, log_path: str,
                         kill_after: float = 3.0) -> int:
    """Start training, wait for the checkpoint at or past `save_steps`, let
    it run `kill_after` seconds more, then SIGKILL. Returns the newest
    checkpoint's step at the kill."""
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        try:
            deadline = time.time() + PHASE1_DEADLINE_S
            while time.time() < deadline:
                if proc.poll() is not None:
                    raise SystemExit(f"phase-1 training exited early rc={proc.returncode} "
                                     f"(see {log_path})")
                steps = [int(d) for d in os.listdir(ckpt_dir)
                         if d.isdigit()] if os.path.isdir(ckpt_dir) else []
                if steps and max(steps) >= save_steps:
                    time.sleep(kill_after)  # let a few more steps run past the save
                    if proc.poll() is not None:
                        raise SystemExit(f"phase-1 training finished before the kill "
                                         f"(see {log_path})")
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    # a checkpoint's directory appears complete (written, then renamed)
                    return max(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
                time.sleep(0.25)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    raise SystemExit(f"phase-1 never reached a checkpoint within {PHASE1_DEADLINE_S} s")


def resumed_step(log_text: str) -> int:
    """N of phase 2's "[train] auto-resumed from step N"."""
    marker = "auto-resumed from step "
    for line in log_text.splitlines():
        if marker in line:
            return int(line.split(marker)[1].split()[0])
    raise SystemExit("phase 2 did not auto-resume")


def logged_rows(out_dir: str) -> list:
    """The metrics rows both phases logged (step, time, loss, ...), in order."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def template_state(cfg, device, dtype, steps: int, lr: float, lora: int):
    """The train state the CLI builds for this run (same seeds, same
    optimizer groups), for a checkpoint to restore into."""
    import torch

    from videoitg_tpu_torch.models.grounding import init_grounding
    from videoitg_tpu_torch.train.train_step import create_train_state

    model = init_grounding(cfg, torch.Generator(device=device).manual_seed(SEED),
                           device=device, dtype=dtype)
    opt = dict(learning_rate=lr, out_proj_lr=lr * 10, total_steps=steps, warmup_ratio=0.03,
               schedule="cosine")
    if lora:
        from videoitg_tpu_torch.train.lora import add_lora, make_lora_optimizer

        add_lora(model, torch.Generator(device=device).manual_seed(SEED + 1), rank=lora)
        tx = make_lora_optimizer(model, **opt)
    else:
        from videoitg_tpu_torch.train.optimizer import make_grounding_optimizer

        tx = make_grounding_optimizer(model, **opt)
    return create_train_state(model, tx)


def evaluate(workdir: str, out_dir: str, n_videos: int, targets: int, steps: int, lr: float,
             lora: int = 0, preset: str = "videoitg-2b", cpu: bool = False) -> float:
    """Restore the newest checkpoint and measure training-set Top-1."""
    import dataclasses as dc

    import torch

    from videoitg_tpu_torch.cli._model_loading import resolve_device
    from videoitg_tpu_torch.config import preset as get_preset
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.train.checkpointing import TrainCheckpointer
    from videoitg_tpu_torch.utils.common import CharTokenizer

    device = resolve_device(cpu, "torch_overfit_smoke", "--cpu")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16  # as the CLI
    cfg = get_preset(preset)
    cfg = dc.replace(cfg, projector=dc.replace(cfg.projector, vision_token_num=BUDGET,
                                               vision_min_num=MIN_HW))
    state = template_state(cfg, device, dtype, steps, lr, lora)
    step, restored = TrainCheckpointer(out_dir).restore_latest(state)
    assert restored is not None, "no checkpoint to evaluate"
    print(f"[overfit] evaluating checkpoint at step {step}", flush=True)

    engine = SelectionEngine(restored.model, cfg, CharTokenizer(cfg.lm.vocab_size),
                             device=device, dtype=dtype, use_flash=device.type == "cuda",
                             num_frames=N_FRAMES, target_fps=float(FPS), buckets=(N_FRAMES,))
    hits = 0
    with torch.no_grad():
        for i in range(n_videos):
            j = i % targets
            res = engine.select_from_file(os.path.join(workdir, "vids", f"v{i}.mp4"),
                                          f"find clip {j}")
            hits += int(res.index[0] == j)
    return hits / n_videos


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="videoitg-2b",
                   help="model preset (tiny runs the loop at a size the CPU takes)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--videos", type=int, default=32)
    p.add_argument("--targets", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-steps", type=int, default=25)
    p.add_argument("--batch", type=int, default=2, help="videos a step")
    p.add_argument("--lora", type=int, default=0,
                   help="train rank-N adapters + the head instead of full weights")
    p.add_argument("--kill-after", type=float, default=3.0,
                   help="seconds phase 1 runs on after its checkpoint before the SIGKILL")
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                     "videoitg_torch_overfit"))
    p.add_argument("--threshold", type=float, default=0.9)
    p.add_argument("--cpu", action="store_true", help="train and evaluate on the CPU")
    return p


def run(args, launcher=TRAIN_CLI) -> dict:
    """Both phases and the evaluation; returns the numbers of the run (the
    last line's and the logs' paths, the step resumed from, the first and
    last logged loss, phase 2's seconds a step)."""
    os.makedirs(args.workdir, exist_ok=True)
    out_dir = os.path.join(args.workdir, "run")
    data = build_data(args.workdir, args.videos, args.targets)
    cmd = train_cmd(args.workdir, data, out_dir, args.steps, args.lr, args.save_steps,
                    batch=args.batch, lora=args.lora, preset=args.preset, cpu=args.cpu,
                    launcher=launcher)

    log1 = os.path.join(args.workdir, "phase1.log")
    t0 = time.perf_counter()
    killed_at = run_phase1_with_kill(cmd, out_dir, args.save_steps, log1, args.kill_after)
    phase1_s = time.perf_counter() - t0
    print(f"[overfit] phase 1 SIGKILLed after checkpoint step {killed_at}", flush=True)

    log2 = os.path.join(args.workdir, "phase2.log")
    t0 = time.perf_counter()
    with open(log2, "w") as log:
        rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO).returncode
    phase2_s = time.perf_counter() - t0
    with open(log2) as f:
        text = f.read()
    assert rc == 0, f"phase-2 training failed rc={rc} (see {log2})"
    resumed = resumed_step(text)
    final = f"[train] done at step {args.steps};"
    assert final in text, f"phase 2 did not reach step {args.steps} (see {log2})"
    print(f"[overfit] phase 2 auto-resumed from step {resumed} and completed", flush=True)

    rows = logged_rows(out_dir)
    # phase 2's rows end the file: one every 5 steps past the resume
    phase2 = rows[-sum(1 for s in range(resumed + 1, args.steps + 1) if s % 5 == 0):]
    times = split_step_times(phase2, args.save_steps)
    print(f"[overfit] loss {rows[0]['loss']:.6f} at step {rows[0]['step']} -> "
          f"{rows[-1]['loss']:.6f} at step {rows[-1]['step']}; phase 2 "
          f"{times['s_per_step']:.4f} s a step with the checkpoints, "
          f"{times['s_per_step_alone']:.4f} without, {times['s_per_checkpoint']:.4f} s a "
          f"checkpoint; phase 1 {phase1_s:.1f} s, phase 2 {phase2_s:.1f} s", flush=True)

    t0 = time.perf_counter()
    acc = evaluate(args.workdir, out_dir, args.videos, args.targets, args.steps, args.lr,
                   lora=args.lora, preset=args.preset, cpu=args.cpu)
    return {"top1_train_accuracy": acc, "steps": args.steps, "videos": args.videos,
            "killed_at_step": killed_at, "pass": acc >= args.threshold,
            "resumed_from_step": resumed, "first_loss": rows[0]["loss"],
            "first_loss_step": rows[0]["step"], "last_loss": rows[-1]["loss"],
            "last_loss_step": rows[-1]["step"], **times, "phase1_s": phase1_s,
            "phase2_s": phase2_s, "eval_s": time.perf_counter() - t0, "logs": (log1, log2)}


def split_step_times(rows: list, save_steps: int) -> dict:
    """Seconds a step over logged `rows` (one every 5 steps, wall times):
    overall, in the intervals without a checkpoint, and what a checkpoint
    adds (one is written right after a row whose step `save_steps` divides)."""
    nan = float("nan")
    pairs = [(a, b) for a, b in zip(rows, rows[1:]) if b["step"] - a["step"] == 5]
    plain = [b["time"] - a["time"] for a, b in pairs if a["step"] % save_steps]
    saving = [b["time"] - a["time"] for a, b in pairs if not a["step"] % save_steps]
    alone = sum(plain) / len(plain) / 5 if plain else nan
    first, last = rows[0], rows[-1]
    return {"s_per_step": ((last["time"] - first["time"]) / (last["step"] - first["step"])
                           if len(rows) > 1 else nan),
            "s_per_step_alone": alone,
            "s_per_checkpoint": sum(saving) / len(saving) - 5 * alone if saving else nan}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    res = run(args)
    print(json.dumps({k: res[k] for k in ("top1_train_accuracy", "steps", "videos",
                                          "killed_at_step", "pass")}))
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
