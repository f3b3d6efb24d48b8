"""The port's `select` CLI takes the JAX CLI's flags: `--cpu` and
`--save-frames DIR`, which writes each selected frame as
`frame_{i:03d}_idx{frame_idx}.jpg` (videoitg_tpu/cli/select.py)."""

import io
import json
import os
import subprocess
import sys

from PIL import Image

from videoitg_tpu_torch.cli.select import build_parser
from videoitg_tpu_torch.data.video import VideoReader, write_test_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parser_takes_the_jax_flags():
    args = build_parser().parse_args(["--cpu", "--video", "v.mp4", "--prompt", "q",
                                      "--save-frames", "out"])
    assert args.cpu and args.save_frames == "out" and args.device is None
    args = build_parser().parse_args(["--device", "cpu", "--video", "v.mp4", "--prompt", "q"])
    assert not args.cpu and args.device == "cpu" and args.save_frames is None


def test_select_cpu_saves_the_selected_frames_in_a_child_process(tmp_path):
    video = write_test_video(str(tmp_path / "vid0.mp4"), 64, 48, 30, 10, 8)
    out_dir = tmp_path / "frames"
    # the arguments of the JAX CLI's own test (tests/test_cli.py), plus --save-frames
    proc = subprocess.run(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.select", "--cpu",
         "--preset", "tiny", "--random-init",
         "--video", video, "--prompt", "q",
         "--topk", "2", "--num-frames", "4", "--json", "--save-frames", str(out_dir)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(record) >= {"index", "logits", "num_frames"}
    selected = sorted(record["index"][:2])
    names = [f"frame_{i:03d}_idx{frame_idx}.jpg" for i, frame_idx in enumerate(selected)]
    assert sorted(os.listdir(out_dir)) == sorted(names)
    assert f"saved 2 frames to {out_dir}" in proc.stderr
    with VideoReader(video) as vr:
        for name, frame_idx in zip(names, selected):
            buf = io.BytesIO()
            Image.fromarray(vr[frame_idx]).save(buf, "JPEG")
            assert (out_dir / name).read_bytes() == buf.getvalue(), name
