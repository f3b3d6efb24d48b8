"""The port's `select` CLI takes the JAX CLI's flags: `--cpu` and
`--save-frames DIR`, which writes each selected frame as
`frame_{i:03d}_idx{frame_idx}.jpg` (videoitg_tpu/cli/select.py).
`--export-serving DIR` writes a serving checkpoint of the port's layout;
a serving checkpoint of the JAX package's layout (an orbax `params/` tree)
as `--model` is refused, naming the remedy (tests/test_torch_serving_checkpoint.py
holds the rest)."""

import io
import json
import os
import subprocess
import sys

from PIL import Image

from videoitg_tpu_torch.cli.select import build_parser, main
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


def test_serving_checkpoints_are_refused_naming_their_item(tmp_path, capsys):
    """The JAX layout's serving directory (serving_config.json + an orbax
    `params/` tree) is refused, naming the port's remedy; `--export-serving`
    itself now writes the port's layout."""
    video = write_test_video(str(tmp_path / "v.mp4"), 64, 48, 30, 10, 8)
    jax_dir = tmp_path / "jax_serving"
    (jax_dir / "params").mkdir(parents=True)
    (jax_dir / "serving_config.json").write_text(
        json.dumps({"format": "videoitg-serving-v1", "quantize": None, "config": {}}))
    assert main(["--model", str(jax_dir), "--cpu", "--video", video, "--prompt", "q"]) == 2
    err = capsys.readouterr().err
    assert "orbax params/ tree" in err and "videoitg-torch-select" in err, err
    assert "--export-serving" in err and "not ported" not in err, err
    out = tmp_path / "port_serving"
    assert main(["--preset", "tiny", "--random-init", "--export-serving", str(out), "--cpu",
                 "--video", video, "--prompt", "q", "--num-frames", "4"]) == 0
    assert {"serving_config.json", "params.safetensors"} <= set(os.listdir(out))
    assert f"serving checkpoint written to {out}" in capsys.readouterr().err
