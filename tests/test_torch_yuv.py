"""The YUV420 transfer of the port against the JAX package: `yuv420_to_rgb`,
`preprocess_frames_yuv`, the engine with `transfer="yuv420"`, and
`collate_grounding` on YUVFrames samples. fp32 on the CPU, planes from numpy
seeds; the cases that decode a file skip where the libav reader cannot be
built.

`yuv420_to_rgb` ends in a round to integers, so the two packages agree
exactly except where the unrounded value sits within the float error of .5:
there they may differ by 1 level. The port builds its chroma weights as jax
does, in float32, also where an odd size makes the factor other than 2; the
asserted bound at every size is 1 level on at most 1 value in 10,000.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.data import video as jax_video
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.ops import preprocess as jax_preprocess
from videoitg_tpu.train import collate as jax_collate
from videoitg_tpu.train import dataset as jax_dataset
from videoitg_tpu.utils.common import CharTokenizer
from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.data import video
from videoitg_tpu_torch.engine import SelectionEngine
from videoitg_tpu_torch.ops import preprocess
from videoitg_tpu_torch.train import collate, dataset

from _torch_bridge import bridged_pair, tiny_params

CFG = preset("tiny")


def _planes(seed, t, h, w):
    rng = np.random.default_rng(seed)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return (rng.integers(0, 256, (t, h, w), dtype=np.uint8),
            rng.integers(0, 256, (t, ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (t, ch, cw), dtype=np.uint8))


SIZES = [(48, 64), (76, 100), (360, 640), (37, 53), (36, 51), (9, 7), (2, 2), (1, 5),
         (361, 641)]


@pytest.mark.parametrize("h,w", SIZES)
def test_yuv420_to_rgb_matches_jax(h, w):
    y, u, v = _planes(h * 100 + w, 3, h, w)
    want = np.asarray(jax_preprocess.yuv420_to_rgb(*(jnp.asarray(p) for p in (y, u, v))))
    got = preprocess.yuv420_to_rgb(*(torch.from_numpy(p) for p in (y, u, v))).numpy()
    assert got.shape == want.shape == (3, h, w, 3) and got.dtype == np.float32
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-4, (diff > 0).sum()


@pytest.mark.parametrize("n_in,n_out", [(2, 4), (1, 2), (3, 5), (19, 37), (27, 53), (181, 361),
                                        (321, 641), (4, 7)])
def test_upsample_weights_match_jax(n_in, n_out):
    """The chroma weights are jax's: resizing the identity along one axis
    gives jax's weight matrix (each output is one weight times 1). Both are
    float32 at every step; jax's compiler may fuse a sample position's
    multiply-add where the source order rounds twice, which moves a weight by
    at most one float32 ulp of the largest position."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in),
                                       method="bilinear"))
    got = preprocess.upsample_weights(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, n_in)
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.float32(n_in)))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_yuv420_to_rgb_grey_and_black():
    """Neutral chroma gives grey; y = 16 is black, y = 0 clips to black too
    (the engine's padding); zero chroma would be green."""
    t, h, w = 1, 6, 8
    chroma = torch.full((t, 3, 4), 128, dtype=torch.uint8)
    for level, expect in ((16, 0.0), (0, 0.0), (235, 255.0), (126, 128.0)):
        rgb = preprocess.yuv420_to_rgb(torch.full((t, h, w), level, dtype=torch.uint8),
                                       chroma, chroma)
        assert torch.equal(rgb, torch.full((t, h, w, 3), expect))
    green = preprocess.yuv420_to_rgb(torch.zeros(t, h, w, dtype=torch.uint8),
                                     torch.zeros_like(chroma), torch.zeros_like(chroma))
    assert green[..., 1].min() > 100 and green[..., 0].max() == 0


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (100, 76)])
def test_preprocess_frames_yuv_matches_jax(h, w):
    y, u, v = _planes(h + w, 2, h, w)
    want = np.asarray(jax_preprocess.preprocess_frames_yuv(
        *(jnp.asarray(p) for p in (y, u, v)), out_size=56, dtype=jnp.float32))
    got = preprocess.preprocess_frames_yuv(*(torch.from_numpy(p) for p in (y, u, v)),
                                           out_size=56, dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, 56, 56, 3)
    # A flipped rounding upstream moves a few resized pixels by one level
    # (2 / 255 after normalisation); everything else agrees to 1e-5.
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() <= 1e-3
    assert diff.max() <= 2.0 / 255 + 1e-5
    # the RGB entry point still gives what it gave
    rgb = np.random.default_rng(1).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        preprocess.preprocess_frames(torch.from_numpy(rgb), out_size=56).numpy(),
        np.asarray(jax_preprocess.preprocess_frames(jnp.asarray(rgb), out_size=56)), atol=1e-5)


@pytest.fixture(scope="module")
def engines():
    params, model = bridged_pair(tiny_params(seed=0))
    tok = CharTokenizer(CFG.lm.vocab_size)
    kw = dict(buckets=(8,), num_frames=8, target_fps=10.0)

    def make(transfer):
        from videoitg_tpu.config import preset as jax_preset

        return (JaxEngine(params, jax_preset("tiny"), tok, dtype=jnp.float32, use_flash=False,
                          transfer=transfer, **kw),
                SelectionEngine(model, CFG, tok, device="cpu", dtype=torch.float32,
                                use_flash=False, transfer=transfer, **kw))
    return make


@pytest.mark.parametrize("t", [8, 5])
def test_engine_yuv420_matches_jax_engine(engines, t):
    """Seeded planes through both yuv420 engines: identical `index`, scores
    within atol 2e-5; 5 frames exercise the padding of the planes to the
    bucket (y = 0, chroma 128)."""
    jax_engine, port = engines("yuv420")
    planes = _planes(40 + t, t, 76, 100)
    sampled = [3 * i for i in range(t)]
    want = jax_engine.select(jax_video.YUVFrames(*planes), sampled, "which frame?")
    got = port.select(video.YUVFrames(*planes), sampled, "which frame?")
    assert got.index == want.index
    np.testing.assert_allclose(got.raw_scores, want.raw_scores, atol=2e-5, rtol=0)
    assert len(got.raw_scores) == t


def test_engine_yuv_padding_is_black(engines):
    """The padded planes preprocess to the same pixels as the RGB path's
    zero frames."""
    _, port = engines("yuv420")
    _, port_rgb = engines("rgb")
    planes = _planes(7, 5, 76, 100)
    pre = port.preprocess_ahead(video.YUVFrames(*planes))
    pre_rgb = port_rgb.preprocess_ahead(np.zeros((5, 76, 100, 3), np.uint8))
    assert pre.t_real == 5 and pre.pix.shape == (8, 56, 56, 3) and pre.ready is None
    assert torch.equal(pre.pix[5:], pre_rgb.pix[5:])
    assert torch.equal(pre.pix[5:], torch.full_like(pre.pix[5:], -1.0))
    # scoring the preprocessed video equals scoring the planes
    a = port.score_frames([pre], ["q"])[0]
    b = port.score_frames([video.YUVFrames(*planes)], ["q"])[0]
    np.testing.assert_array_equal(a, b)


def test_engine_rejects_unknown_transfer(engines):
    _, port = engines("rgb")
    with pytest.raises(ValueError, match="transfer"):
        SelectionEngine(port.model, CFG, port.tokenizer, transfer="nv12")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import subprocess

    root = tmp_path_factory.mktemp("yuv")
    try:
        return (video.write_test_video(str(root / "v.mp4"), 100, 76, 30, 10, 8),
                video.write_test_video(str(root / "v5.mp4"), 100, 76, 5, 10, 8))
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")


def test_engine_yuv_transfer_matches_rgb_inside_the_port(engines, clip):
    """tests/test_engine.py::test_engine_yuv_transfer_matches_rgb on the port,
    at its tolerance: scores within 2e-2 (colourspace rounding on a random
    tiny model), identical ranking, and the short video's padding."""
    path, path5 = clip
    jax_yuv, port_yuv = engines("yuv420")
    _, port_rgb = engines("rgb")
    r_rgb = port_rgb.select_from_file(path, "which frame?")
    r_yuv = port_yuv.select_from_file(path, "which frame?")
    assert r_yuv.sampled_frames == r_rgb.sampled_frames
    np.testing.assert_allclose(r_yuv.raw_scores, r_rgb.raw_scores, atol=2e-2, rtol=0)
    assert r_yuv.index == r_rgb.index
    yuv, _ = video.read_video_frames(path, num_frames=8, target_fps=10.0, pix_fmt="yuv420")
    assert isinstance(yuv, video.YUVFrames)
    np.testing.assert_allclose(port_yuv.score_frames([yuv], ["which frame?"])[0],
                               r_yuv.raw_scores, atol=1e-6)
    r5_rgb = port_rgb.select_from_file(path5, "which frame?")
    r5_yuv = port_yuv.select_from_file(path5, "which frame?")
    assert len(r5_yuv.raw_scores) == len(r5_rgb.raw_scores) == 5
    np.testing.assert_allclose(r5_yuv.raw_scores, r5_rgb.raw_scores, atol=2e-2, rtol=0)
    # and the decoded file through the JAX yuv420 engine
    want = jax_yuv.select_from_file(path, "which frame?")
    assert r_yuv.index == want.index
    np.testing.assert_allclose(r_yuv.raw_scores, want.raw_scores, atol=2e-5, rtol=0)


def test_cli_select_yuv420(clip, capsys):
    import json

    from videoitg_tpu_torch.cli.select import main

    argv = ["--preset", "tiny", "--random-init", "--video", clip[0], "--prompt", "q",
            "--device", "cpu", "--num-frames", "8", "--target-fps", "10", "--json"]
    assert main(argv) == 0
    rgb = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(argv + ["--transfer", "yuv420"]) == 0
    yuv = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(yuv["index"]) == sorted(rgb["index"]) and len(yuv["index"]) == 8
    np.testing.assert_allclose(sorted(yuv["logits"]), sorted(rgb["logits"]), atol=0.03)


@pytest.mark.parametrize("lengths", [(3,), (4, 6)])
def test_collate_yuv_matches_jax(lengths):
    """YUVFrames samples: padded (y 0, chroma 128) or truncated to the bucket
    of 4, converted and resized; against the JAX collate on the same planes."""
    def samples(cls, frames_cls):
        rng = np.random.default_rng(3)
        out = []
        for i, t in enumerate(lengths):
            planes = _planes(50 + i, t, 40, 52)
            labels = (rng.random(t) < 0.5).astype(np.float32)
            out.append(cls(frames_cls(*planes), [5, 6 + i], labels, f"v{i}"))
        return out

    from videoitg_tpu.config import GroundingConfig as JaxConfig

    want = jax_collate.collate_grounding(
        samples(jax_dataset.GroundingSample, jax_video.YUVFrames), 4, JaxConfig.tiny(),
        dtype=jnp.float32)
    got = collate.collate_grounding(samples(dataset.GroundingSample, video.YUVFrames), 4, CFG,
                                    dtype=torch.float32)
    assert got.frames.shape == tuple(want.frames.shape)
    diff = np.abs(got.frames.numpy() - np.asarray(want.frames))
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 2.0 / 255 + 1e-5
    for field in ("frame_valid", "text_ids", "text_valid", "labels"):
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field))), field
    if lengths == (3,):
        assert torch.equal(got.frames[0, 3:], torch.full_like(got.frames[0, 3:], -1.0))
