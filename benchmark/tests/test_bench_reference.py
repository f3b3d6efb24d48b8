"""The plain reference against the port at the `tiny` preset on the CPU,
where the port's kernels run their plain versions; and its preprocessing
against PIL itself."""

import dataclasses

import numpy as np
import torch

from benchmark.check import gaps, logits_of
from benchmark.inputs import derive, make_traffic
from benchmark.port import build_engine
from benchmark.reference import model as ref
from benchmark.weights import make_weights

SEED = 2 ** 33 + 5


def _setup(tier, dtype="float32"):
    from videoitg_tpu_torch.config import preset

    cfg = {"model": dataclasses.asdict(preset("tiny")), "dtype": dtype, "tier": tier,
           "kernels": {"qgemm": True, "fused": True, "lm_splash": False}}
    mix = {"videos": 1, "frames": 8, "height": 48, "width": 64, "grid": [3, 4], "noise": 24,
           "instructions": 3, "chars": [10, 30]}
    return cfg, make_traffic(mix, SEED, "cpu")


def _scores(cfg, traffic, dtype):
    state = make_weights(cfg["model"], derive(SEED, "weights"), "cpu", dtype)
    engine = build_engine(cfg, state, torch.device("cpu"))
    video = traffic.videos[0]
    sel = [engine.select(video, list(range(len(video))), q).raw_scores
           for q in traffic.instructions]
    enc = engine.encode_video(video)
    reuse = engine.score_encoded(enc, traffic.instructions)
    state = make_weights(cfg["model"], derive(SEED, "weights"), "cpu", dtype)
    with torch.no_grad():
        img = ref.encode(state, cfg, torch.from_numpy(video))
        want = [ref.scores(state, cfg, img, len(video), q) for q in traffic.instructions]
    return sel, reuse, want


def test_reference_matches_the_port_in_float32():
    cfg, traffic = _setup(None)
    sel, reuse, want = _scores(cfg, traffic, torch.float32)
    for got in (sel, reuse):
        # float32 on both sides; the port's resize works with float32
        # coefficients where PIL's are fixed point, which moves a few pixels
        # by one level (1e-4 of them here): 4e-4 of a logit
        assert gaps(got, want)["logit_max"] < 2e-3


def test_reference_matches_the_port_in_act8():
    cfg, traffic = _setup("act8")
    sel, reuse, want = _scores(cfg, traffic, torch.float32)
    _, _, dense = _scores(dict(cfg, tier=None), traffic, torch.float32)
    for got in (sel, reuse):
        # A value that a pixel or a rounding moves across an int8 step moves
        # by a whole step, so whole act8 paths agree less closely than float32
        # ones (the port's one-level resize differences alone do this); still
        # closer to the act8 reference than to the dense model.
        near, far = gaps(got, want)["logit_max"], gaps(got, dense)["logit_max"]
        assert near < 0.03 and near < far, (near, far)


def test_act8_linears_match_the_port_exactly():
    from videoitg_tpu_torch.models.common import linear
    from videoitg_tpu_torch.models.siglip import _encoder_layer

    cfg, _ = _setup("act8")
    state = make_weights(cfg["model"], derive(SEED, "weights"), "cpu", torch.float32)
    engine = build_engine(cfg, state, torch.device("cpu"))
    state = make_weights(cfg["model"], derive(SEED, "weights"), "cpu", torch.float32)
    lin = ref.Linears(state, "act8")
    x = torch.randn(7, cfg["model"]["lm"]["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        for name in ("q", "k", "v", "gate", "up"):
            got = linear(getattr(engine.model.lm.layers[1], name), x, engine.act8)
            torch.testing.assert_close(got, lin(f"lm.layers.1.{name}", x, True),
                                       rtol=1e-6, atol=1e-6)
        v = cfg["model"]["vision"]
        t = torch.randn(2, 16, v["hidden_size"], generator=torch.Generator().manual_seed(2))
        got = _encoder_layer(engine.model.vision.layers[0], t, engine.cfg.vision, False,
                             engine.act8)
    pix = torch.zeros(2, v["image_size"], v["image_size"], 3)
    one = dict(v, select_layer=1)  # the tower's first layer alone
    state["vision.patch_embed.w"] = torch.zeros_like(state["vision.patch_embed.w"])
    state["vision.patch_embed.b"] = torch.zeros_like(state["vision.patch_embed.b"])
    state["vision.pos_embed"] = t[0]
    want = ref.tower(state, lin, one, pix[:1])
    torch.testing.assert_close(got[:1], want, rtol=1e-5, atol=1e-5)


def test_instructions_move_the_reference():
    cfg, traffic = _setup(None)
    _, _, want = _scores(cfg, traffic, torch.float32)
    assert gaps([want[0]], [want[1]])["logit_max"] > 1e-2


def test_reference_preprocess_is_pil_bicubic():
    from PIL import Image

    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 45, 70, 3), dtype=np.uint8)
    got = ref.preprocess(torch.from_numpy(frames), 32)
    for i in range(2):
        want = np.asarray(Image.fromarray(frames[i]).resize((32, 32), Image.BICUBIC),
                          dtype=np.float32)
        np.testing.assert_array_equal(((got[i].numpy() * 0.5 + 0.5) * 255.0).round(), want)


def test_logits_of_inverts_the_sigmoid():
    x = np.linspace(-8, 8, 11)
    np.testing.assert_allclose(logits_of(1 / (1 + np.exp(-x))), x, atol=1e-9)
