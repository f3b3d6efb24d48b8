"""Whole runs of a cell on the CPU (the `tiny` preset, small frames), past
the look for a card, with the timed path broken underneath: each fault this
kind of cell can have makes `correct` false; a sound run is correct."""

import pytest
import torch

from _tiny import run_tiny


def _patch_logits(monkeypatch, change):
    """Break grounding_logits_from_tokens where the engine's two entry
    points call it (select through grounding_logits, score_encoded directly)."""
    from videoitg_tpu_torch import engine as engine_mod
    from videoitg_tpu_torch.models import grounding as grounding_mod

    orig = grounding_mod.grounding_logits_from_tokens

    def broken(model, img, frame_valid, *args, **kwargs):
        return change(orig, model, img, frame_valid, *args, **kwargs)

    monkeypatch.setattr(grounding_mod, "grounding_logits_from_tokens", broken)
    monkeypatch.setattr(engine_mod, "grounding_logits_from_tokens", broken)


def _one_answer_altered(orig, *args, **kwargs):
    logits = orig(*args, **kwargs)
    return logits + torch.nn.functional.one_hot(torch.tensor(3), logits.shape[-1]) * 1.0


def _half_the_frames_left_out(orig, model, img, frame_valid, *args, **kwargs):
    fv = frame_valid.clone()
    real = int(frame_valid[0].sum())
    fv[:, real // 2:] = False
    return orig(model, img, fv, *args, **kwargs)


WORKLOADS = ["itg8b.select512", "itg8b.reuse12", "itg8b-act8.select512", "itg8b-act8.reuse12"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [_one_answer_altered, _half_the_frames_left_out])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    _patch_logits(monkeypatch, fault)
    result = run_tiny(workload, seconds=0.2)
    assert result["correct"] is False
    assert result["failed"] == 0 and result["metrics"]


def plant_stale_answer(monkeypatch):
    """score_encoded answers every question on a video with its first answer."""
    from videoitg_tpu_torch.engine import SelectionEngine

    orig = SelectionEngine.score_encoded
    first = {}

    def stale(self, enc, instructions):
        out = orig(self, enc, instructions)
        return first.setdefault(id(enc), out)

    monkeypatch.setattr(SelectionEngine, "score_encoded", stale)


def plant_wrong_instruction(monkeypatch):
    """select and score_encoded answer each call under the instruction of
    the call before it: another request's."""
    from videoitg_tpu_torch.engine import SelectionEngine

    last = {}

    def swap(instruction):
        prev = last.get("i", instruction + " and why?")
        last["i"] = instruction
        return prev

    orig_select, orig_score = SelectionEngine.select, SelectionEngine.score_encoded

    def select(self, frames, indices, instruction, *args, **kwargs):
        return orig_select(self, frames, indices, swap(instruction), *args, **kwargs)

    def score_encoded(self, enc, instructions):
        return orig_score(self, enc, [swap(q) for q in instructions])

    monkeypatch.setattr(SelectionEngine, "select", select)
    monkeypatch.setattr(SelectionEngine, "score_encoded", score_encoded)


# the faults of the timed path that each cell can have: a stale answer only
# where a video's encoding serves several questions
PLANTED = [(w, plant_wrong_instruction) for w in WORKLOADS] + [
    (w, plant_stale_answer) for w in ("itg8b.reuse12", "itg8b-act8.reuse12")]


@pytest.mark.parametrize("workload", ["itg8b.reuse12", "itg8b-act8.reuse12"])
def test_a_stale_answer_is_not_correct(monkeypatch, workload):
    plant_stale_answer(monkeypatch)
    assert run_tiny(workload, seconds=0.2)["correct"] is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_wrong_instruction_is_not_correct(monkeypatch, workload):
    plant_wrong_instruction(monkeypatch)
    assert run_tiny(workload, seconds=0.2)["correct"] is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    result = run_tiny(workload, seconds=0.2)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) <= {"logit_max", "logit_crms", "logit_shift"}


def test_the_traced_run_reports_the_per_layer_metrics_it_can_read():
    result = run_tiny("itg8b.select512", seconds=0.2, trace=True)
    # no device on the CPU: no device metric is written, only what is counted
    assert set(result["metrics"]) == set()
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    assert result["breakdown"]["device_ops"] == []
