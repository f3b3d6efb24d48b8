"""The port's VLM SFT pipeline (videoitg_tpu_torch/train/vlm_sft.py, the
`--objective vlm` arm of cli/train.py, train/offload.py) against the JAX
package's.

`collate_vlm` arrays must be equal (pixels within the fp32 resize's 1e-5);
4-step trajectories of `make_vlm_train_step` (full finetune and LoRA r4, fp32,
`preset("tiny")` causal and tied, the same start and the same batches) keep
the loss within 1e-4 at every step and the trained leaves within 1e-4 at the
end; the dataset reads the same samples; the CLI takes steps in a child
process on one image record and one synthetic video record, with both
templates.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bridge import by_port_name, causal_cfgs, to_numpy_tree
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.models.vlm import vlm_loss as jax_vlm_loss
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu.train import optimizer as jax_optimizer
from videoitg_tpu.train import train_step as jax_train_step
from videoitg_tpu.train import vlm_sft as jax_sft
from videoitg_tpu.utils.common import CharTokenizer as JaxCharTokenizer
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.train import lora, offload, optimizer, train_step, vlm_sft
from videoitg_tpu_torch.utils.common import CharTokenizer

HW = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(seed, n=2, t=(2, 1), size=56):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        frames = rng.integers(0, 256, size=(t[i], size + 8 * i, size, 3), dtype=np.uint8)
        n_pre, n_post = 2 + i, 5 - i
        post = rng.integers(1, 500, n_post).tolist()
        labels = [-100] * (n_post // 2) + post[n_post // 2:]
        out.append((frames, rng.integers(1, 500, n_pre).tolist(), post, labels))
    return out


def _both(samples):
    return ([jax_sft.VLMSample(*s) for s in samples], [vlm_sft.VLMSample(*s) for s in samples])


def _collated(seed, **kw):
    jcfg, cfg = causal_cfgs()
    js, ts = _both(_samples(seed, **kw))
    jb = jax_sft.collate_vlm(js, t_bucket=2, cfg=jcfg, max_pre=4, max_post=6, dtype=jnp.float32)
    tb = vlm_sft.collate_vlm(ts, t_bucket=2, cfg=cfg, max_pre=4, max_post=6, dtype=torch.float32)
    return jb, tb


def test_collate_vlm_arrays_equal():
    jb, tb = _collated(0)
    assert type(tb).__module__ == "videoitg_tpu_torch.models.vlm"
    for name in tb._fields:
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "frames":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    # Sample 1 has one frame in a bucket of two, 3 of 4 pre and 4 of 6 post slots.
    assert tb.frame_valid.tolist() == [[True, True], [True, False]]
    assert tb.pre_valid.sum(dim=1).tolist() == [2, 3] and tb.post_valid.sum(dim=1).tolist() == [5, 4]
    assert (tb.post_labels[~tb.post_valid] == -100).all()


def test_collate_vlm_truncates_frames_and_text():
    jcfg, cfg = causal_cfgs()
    js, ts = _both(_samples(1, t=(5, 3)))
    jb = jax_sft.collate_vlm(js, t_bucket=2, cfg=jcfg, max_pre=2, max_post=3, dtype=jnp.float32)
    tb = vlm_sft.collate_vlm(ts, t_bucket=2, cfg=cfg, max_pre=2, max_post=3, dtype=torch.float32)
    assert tuple(tb.frames.shape) == (2, 2, 56, 56, 3) and tb.frame_valid.all()
    for name in ("pre_ids", "pre_valid", "post_ids", "post_valid", "post_labels"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_allclose(tb.frames.numpy(), np.asarray(jb.frames), atol=1e-5, rtol=1e-5)
    assert vlm_sft.collate_vlm(ts, 2, cfg).frames.dtype == torch.bfloat16  # the default


OPT = dict(total_steps=4, warmup_ratio=0.3, max_grad_norm=1.0, weight_decay=0.01,
           learning_rate=1e-3)


def _setup(kind):
    jcfg, cfg = causal_cfgs()
    params = jax_init_grounding(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    if kind == "lora":
        params = jax_lora.add_lora(params, jax.random.PRNGKey(6), rank=4)
        model = params_from_numpy(to_numpy_tree(params), cfg)
        return (jcfg, params, jax_lora.make_lora_optimizer(params, **OPT), cfg, model,
                lora.make_lora_optimizer(model, **OPT))
    model = params_from_numpy(to_numpy_tree(params), cfg)
    return (jcfg, params, jax_optimizer.make_grounding_optimizer(params, **OPT), cfg, model,
            optimizer.make_grounding_optimizer(model, **OPT))


@pytest.mark.parametrize("kind,use_flash", [("full", False), ("lora", True)])
def test_four_step_vlm_trajectory_matches_jax(kind, use_flash):
    jcfg, params, jax_tx, cfg, model, port_tx = _setup(kind)
    start = {n: t.detach().clone() for n, t in model.state_dict().items()}
    trainable = set(port_tx.trainable_names())
    jax_state = jax_train_step.create_train_state(params, jax_tx)
    jax_step = jax_sft.make_vlm_train_step(jcfg, jax_tx, hw=HW, use_flash=use_flash)
    state = train_step.create_train_state(model, port_tx)
    step_fn = vlm_sft.make_vlm_train_step(cfg, port_tx, hw=HW, use_flash=use_flash)
    for i in range(4):
        jb, tb = _collated(20 + i)
        grads = jax.grad(lambda p: jax_vlm_loss(p, jb, jcfg, hw=HW, use_flash=use_flash)[0])(
            jax_state.params)
        flat = by_port_name(to_numpy_tree(grads))
        want_norm = np.sqrt(sum(float(np.sum(np.square(flat[n].astype(np.float64))))
                                for n in trainable))
        jax_state, want = jax_step(jax_state, jb)
        state, got = train_step.run_step(step_fn, state, tb)
        assert state.step == int(jax_state.step) == i + 1
        assert set(got) == set(want) == {"loss", "num_label_tokens", "grad_norm"}
        assert int(got["num_label_tokens"]) == int(want["num_label_tokens"]) == 5
        assert abs(float(got["loss"]) - float(want["loss"])) < 1e-4, i
        assert abs(float(got["grad_norm"]) - want_norm) < 1e-3 * want_norm + 1e-6, i
    want = by_port_name(to_numpy_tree(jax_state.params))
    end = model.state_dict()
    for name in trainable:
        scale = max(1.0, float(np.abs(want[name]).max()))
        assert np.abs(end[name].numpy() - want[name]).max() < 1e-4 * scale, name
    changed = {n for n in end if not torch.equal(end[n], start[n])}
    assert changed and changed <= trainable
    # The scoring head gets no gradient from this loss; in a full finetune
    # only its weight decay moves it, alike in both packages.
    assert not any(n.startswith("vision.") for n in changed)
    if kind == "lora":
        assert all(".lora_" in n or n.startswith("out_proj.") for n in changed)


def test_repeating_one_batch_drives_the_vlm_loss_down():
    _, _, _, cfg, model, _ = _setup("full")
    tx = optimizer.make_grounding_optimizer(model, learning_rate=5e-3, total_steps=20,
                                            schedule="constant", warmup_ratio=0.0,
                                            max_grad_norm=None)
    state = train_step.create_train_state(model, tx)
    step_fn = vlm_sft.make_vlm_train_step(cfg, tx, hw=HW, use_flash="train-jax", remat=True)
    _, tb = _collated(30)
    losses = []
    for _ in range(8):
        state, m = train_step.run_step(step_fn, state, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_offloaded_step_is_the_same_step():
    """The optimizer-offload wrapper changes where Adam's moments live between
    steps, never a number: the trajectory equals the plain one bit for bit.
    (On the CPU there is no device to move from; the card run checks that the
    moments really sit in pinned host memory.)"""
    ends = []
    for wrap in (False, True):
        _, _, _, cfg, model, tx = _setup("lora")
        state = train_step.create_train_state(model, tx)
        step_fn = vlm_sft.make_vlm_train_step(cfg, tx, hw=HW)
        if wrap:
            step_fn = offload.make_offloaded_train_step(step_fn)
        for i in range(3):
            state, _ = train_step.run_step(step_fn, state, _collated(40 + i)[1])
        if wrap:
            assert offload.offload_opt_state(tx) == 0  # nothing lies on a CUDA device here
            assert any("exp_avg" in s for s in tx.optimizer.state.values())
        ends.append({n: p.detach().clone() for n, p in model.named_parameters()})
    assert all(torch.equal(ends[0][n], ends[1][n]) for n in ends[0])
    assert not offload.supports_host_offload(torch.device("cpu"))
    assert offload.supports_host_offload(torch.device("cuda:0"))


# ---- the dataset and the CLI ----


CONVS = [{"from": "human", "value": "<image>\nwhat is shown?"},
         {"from": "gpt", "value": "a red square"}]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image

    from videoitg_tpu_torch.data.video import write_test_video

    root = tmp_path_factory.mktemp("vlm_sft")
    try:
        write_test_video(str(root / "clip.mp4"), 64, 48, 40, 10, 12)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(root / "pic.png")
    records = [{"image": "pic.png", "conversations": CONVS},
               {"video": "clip.mp4", "conversations": CONVS}]
    (root / "sft.json").write_text(json.dumps(records))
    (root / "broken.json").write_text(json.dumps(
        [{"video": "missing.mp4", "conversations": CONVS}] * 2))
    return root


@pytest.mark.parametrize("template", ["plain", "chatml"])
@pytest.mark.parametrize("fps", [1.0, -1])
def test_dataset_reads_what_the_jax_dataset_reads(workdir, template, fps):
    jcfg, cfg = causal_cfgs()
    kw = dict(template=template, video_frames=4, fps=fps, seed=3)
    theirs = jax_sft.VLMDataset(str(workdir / "sft.json"), str(workdir), JaxCharTokenizer(512),
                                jcfg, **kw)
    ours = vlm_sft.VLMDataset(str(workdir / "sft.json"), str(workdir), CharTokenizer(512), cfg,
                              **kw)
    assert len(ours) == len(theirs) == 2 and vlm_sft.FPS_CHOICES == jax_sft.FPS_CHOICES
    for i in (0, 1, 1):  # the video twice: with fps -1 the draw moves on, alike
        a, b = ours[i], theirs[i]
        assert type(a).__module__ == "videoitg_tpu_torch.train.vlm_sft"
        assert np.array_equal(a.frames, b.frames) and a.frames.dtype == np.uint8
        assert (a.pre_ids, a.post_ids, a.post_labels) == (b.pre_ids, b.post_ids, b.post_labels)
    assert ours[0].frames.shape == (1, 40, 60, 3)
    assert (len(ours[0].pre_ids) == 0) == (template == "plain")


def test_dataset_retries_then_gives_up(workdir, capsys):
    _, cfg = causal_cfgs()
    ds = vlm_sft.VLMDataset(str(workdir / "broken.json"), str(workdir), CharTokenizer(512), cfg,
                            template="plain", max_attempts=3)
    with pytest.raises(RuntimeError, match="exceeded max retries"):
        ds[0]
    assert capsys.readouterr().out.count("[vlm dataset] error on sample") == 3


BASE = ["--preset", "tiny", "--random-init", "--data-path", "sft.json", "--image-folder", ".",
        "--objective", "vlm", "--video-frames", "4", "--fps", "1", "--num-train-epochs", "4"]


def _train(workdir, *flags, cpu=True):
    cmd = [sys.executable, "-m", "videoitg_tpu_torch.cli.train", *BASE, *flags]
    if cpu:
        cmd.append("--cpu")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("name,flags", [
    ("plain", ("--conv-template", "plain")),
    ("chatml", ("--conv-template", "chatml")),
    ("lora", ("--conv-template", "chatml", "--lora", "4", "--fps", "-1")),
    ("qlora8", ("--lora", "4", "--quantize-base", "int8")),
    ("offload", ("--offload-optimizer",)),
])
def test_cli_takes_three_vlm_steps(workdir, name, flags):
    proc = _train(workdir, "--total-steps", "3", "--output-dir", name, *flags)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step ")]
    assert len(lines) == 3 and lines[-1].startswith("[train] step 3/3 loss=")
    rows = [json.loads(line) for line in open(workdir / name / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert set(rows[0]) == {"step", "time", "loss", "num_label_tokens", "grad_norm"}
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 and r["num_label_tokens"] > 0
               for r in rows)
    assert os.listdir(workdir / name / "checkpoints") == ["3"]
    assert ("host offload unsupported on this backend; ignoring" in proc.stdout) == \
        (name == "offload")


def test_cli_vlm_refuses_the_feature_cache_and_the_cpu_unasked(workdir):
    proc = _train(workdir, "--feature-cache", "fc", "--output-dir", "never")
    assert proc.returncode == 2
    assert "--feature-cache supports the grounding objective only" in proc.stderr
    if not torch.cuda.is_available():
        proc = _train(workdir, "--output-dir", "never", cpu=False)
        assert proc.returncode != 0 and "no CUDA device found" in proc.stderr
    assert not (workdir / "never").exists()
