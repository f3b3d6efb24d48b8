"""The benchmark's operation counts reproduce the port's kernel table."""

import math

import pytest

from benchmark.manifest import Manifest
from benchmark.roofline import (PEAK_BF16, attention_work, bound_seconds, request_work,
                                score_work, tower_work)

MODEL = Manifest().config(Manifest().workload("itg8b.select512"))["model"]


def test_kernel_a_launch_is_313_gflop():
    ops, nbytes = attention_work(128, 16, 16, 729, 72)
    assert ops / 1e9 == pytest.approx(313.4, abs=0.1)  # PERF.md: "313.4 GFLOP"
    assert bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.3169, abs=1e-4)


def test_kernel_b_launch_is_2_444_tflop():
    ops, _ = attention_work(1, 28, 4, 13056, 128)
    assert ops / 1e12 == pytest.approx(2.444, abs=5e-4)
    assert bound_seconds(ops, 0) * 1e3 == pytest.approx(2.4709, abs=1e-3)
    masked, _ = attention_work(1, 28, 4, 13056, 128, pairs=[12840 ** 2])
    assert masked / 1e12 == pytest.approx(2.364, abs=5e-4)


def test_a_512_frame_bf16_request_is_568_tflop():
    tower, score = tower_work(MODEL, None, 512), score_work(MODEL, None, 512, 256)
    assert tower.attention_ops / 1e12 == pytest.approx(104 * 0.3134, rel=1e-3)
    assert score.attention_ops / 1e12 == pytest.approx(28 * 2.444, rel=1e-3)
    assert tower.bf16_ops / 1e12 == pytest.approx(296.0, abs=0.5)  # with the patch embedding
    total = (tower.ops + score.ops) / 1e12
    assert total == pytest.approx(568, rel=0.01)
    w = request_work(MODEL, None, 512, 256, with_tower=True)
    assert w.ops / 1e12 == pytest.approx(total, rel=1e-9)
    assert w.int8_ops == 0


def test_act8_moves_the_encoder_and_lm_linears_to_the_int8_peak():
    bf16 = request_work(MODEL, None, 512, 100, with_tower=True)
    act8 = request_work(MODEL, "act8", 512, 100, with_tower=True)
    assert act8.ops == pytest.approx(bf16.ops)
    assert act8.int8_ops / 1e12 == pytest.approx(295.5 + 170.4 * (12900 / 13056), rel=0.01)
    assert act8.least_s < bf16.least_s
    assert bf16.least_s == pytest.approx(bf16.bf16_ops / PEAK_BF16 + bf16.attention_s)


def test_a_question_without_the_tower_is_the_lm_and_projector():
    q = request_work(MODEL, None, 512, 256, with_tower=False)
    assert q.ops / 1e12 == pytest.approx(170.4 + 68.4 + 0.43, rel=0.01)
    assert math.isclose(q.attention_ops, 28 * attention_work(1, 28, 4, 13056, 128)[0])


def test_attention_counts_the_value_head_dim_apart():
    # MLA's prefill: q and k at 128 + 64 = 192, v and the output at 128
    n = 12800 + 129
    ops, nbytes = attention_work(1, 16, 16, n, 192, dv=128)
    assert ops == 2.0 * n * n * 16 * (192 + 128)
    assert nbytes == 2.0 * n * (32 * 192 + 32 * 128)
    assert 27 * ops / 1e12 == pytest.approx(46.2, abs=0.1)  # 27 layers a question
    assert attention_work(1, 16, 16, n, 192, dv=192) == attention_work(1, 16, 16, n, 192)
