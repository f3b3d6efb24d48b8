"""Traffic and weights repeat exactly for a seed and differ across seeds;
every seed asks for the same work."""

import dataclasses

import numpy as np
import torch

from benchmark.inputs import derive, make_instructions, make_traffic
from benchmark.manifest import Manifest
from benchmark.reference.model import char_ids
from benchmark.weights import make_weights

BIG = 2 ** 31 + 12345  # seeds go past 32 signed bits
MIX = dict(Manifest().mix(Manifest().workload("itg8b.select512")), frames=4, height=20,
           width=36, videos=2)


def _tiny_model():
    from videoitg_tpu_torch.config import preset

    return dataclasses.asdict(preset("tiny"))


def test_traffic_repeats_for_a_seed_and_differs_across_seeds():
    a, b = make_traffic(MIX, BIG, "cpu"), make_traffic(MIX, BIG, "cpu")
    c = make_traffic(MIX, BIG + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.videos, b.videos))
    assert a.instructions == b.instructions
    assert not np.array_equal(a.videos[0], c.videos[0])
    assert a.instructions != c.instructions
    assert a.videos[0].dtype == np.uint8 and a.videos[0].shape == (4, 20, 36, 3)


def test_every_seed_gets_the_same_instruction_lengths():
    lengths = [sorted(len(s) for s in make_instructions(MIX, seed)) for seed in (1, BIG, 7)]
    assert lengths[0] == lengths[1] == lengths[2]
    lo, hi = MIX["chars"]
    assert lengths[0][0] == lo and lengths[0][-1] == hi


def test_instructions_fit_the_text_slots():
    cfg = Manifest().config(Manifest().workload("itg8b.select512"))
    for s in make_instructions(MIX, BIG):
        ids = char_ids(s, cfg["model"]["lm"]["vocab_size"], 10 ** 6)
        assert len(ids) <= cfg["model"]["max_text_len"]


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    model = _tiny_model()
    a = make_weights(model, derive(BIG, "weights"), "cpu", torch.bfloat16)
    b = make_weights(model, derive(BIG, "weights"), "cpu", torch.bfloat16)
    c = make_weights(model, derive(BIG + 1, "weights"), "cpu", torch.bfloat16)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm.layers.0.q.w"], c["lm.layers.0.q.w"])


def test_weights_are_the_ports_state_dict():
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.models.grounding import GroundingModel

    model = _tiny_model()
    sd = GroundingModel(preset("tiny"), device="meta", dtype=torch.bfloat16).state_dict()
    ours = make_weights(model, 3, "cpu", torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_the_lm_query_and_key_biases_are_large():
    from benchmark.weights import QK_BIAS

    model = _tiny_model()
    w = make_weights(model, 5, "cpu", torch.float32)
    for i in range(model["lm"]["num_layers"]):
        for name in ("q", "k"):
            assert abs(float(w[f"lm.layers.{i}.{name}.b"].std()) / QK_BIAS - 1) < 0.5
        assert float(w[f"lm.layers.{i}.v.b"].std()) < 0.05
    assert all(float(w[f"vision.layers.0.{n}.b"].std()) < 0.05 for n in ("q", "k"))
