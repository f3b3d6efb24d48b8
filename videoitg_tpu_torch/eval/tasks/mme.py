"""MME image benchmark (parity: lmms_eval/tasks/mme/utils.py, mme.yaml).

First image task in the harness: downstream adapters consume stills
through the same path as videos (FrameSelectionConsumer loads an
image-extension visual as a single frame), so a stage-2 image-SFT
checkpoint can be validated without leaving the framework.

Docs (local-first, like every task here): question_id / image (path
relative to data_root; the reference's HF split embeds a PIL object,
utils.py:37-38) / question / answer ("Yes"/"No") / category. MME is
pairwise — every image carries exactly two questions sharing a
question_id, and the aggregation asserts that structure exactly like the
reference (utils.py:116).

Scoring parity:
- answer normalization, the Otter-eval parser (utils.py:52-73): exact
  yes/no, single-letter y/n, else yes/no within the first 4 chars,
  otherwise "other" (counted wrong).
- per-category score = mean over images of (acc + acc_plus), where acc is
  the pair mean *100 and acc_plus is 100 only if both answers are right
  (utils.py:113-121); the reported totals sum the 10 Perception / 4
  Cognition category scores (utils.py:12-31, 125).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

PERCEPTION = [
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
]
COGNITION = [
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
]

# Embedded in the dataset's questions; stripped when a pre/post prompt is
# configured (utils.py:34,43-48).
REPLACE_PROMPT = " Please answer yes or no."


def doc_to_visual(doc, data_root: str = ""):
    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(
    doc, pre_prompt: str = "",
    post_prompt: str = "\nAnswer the question using a single word or phrase.",
) -> str:
    """utils.py:41-49 with the yaml's default kwargs (mme.yaml:28-31)."""
    question = doc["question"].strip()
    if pre_prompt:
        question = pre_prompt + question.replace(REPLACE_PROMPT, "")
    if post_prompt:
        question = question.replace(REPLACE_PROMPT, "") + post_prompt
    return question


def parse_pred_ans(pred_ans: str) -> str:
    """Otter-eval normalization (utils.py:52-73)."""
    pred_ans = pred_ans.lower().strip().replace(".", "")
    if pred_ans in ("yes", "no"):
        return pred_ans
    if len(pred_ans) == 1:
        return {"y": "yes", "n": "no"}.get(pred_ans, "other")
    prefix = pred_ans[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def process_results(doc, response: str) -> dict:
    pred = parse_pred_ans(response)
    gt = doc["answer"].lower().strip().replace(".", "")
    assert gt in ("yes", "no"), f"bad MME gold answer {doc['answer']!r}"
    return {
        "question_id": doc["question_id"],
        "category": doc["category"],
        "pred": pred,
        "score": 1.0 if pred == gt else 0.0,
    }


def _category_scores(records: List[dict]) -> Dict[str, float]:
    by_cat: Dict[str, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(list))
    for r in records:
        by_cat[r["category"]][r["question_id"]].append(r["score"])
    out = {}
    for cat, pairs in by_cat.items():
        total = 0.0
        for qid, scores in pairs.items():
            assert len(scores) == 2, (
                f"MME only supports pairwise evaluation ({cat}/{qid}: "
                f"{len(scores)} answers)")  # utils.py:116
            acc = sum(scores) / len(scores) * 100.0
            acc_plus = (sum(scores) == 2) * 100.0
            total += acc + acc_plus
        out[cat] = total / len(pairs)
    return out


def aggregate(records: List[dict]) -> Dict[str, float]:
    cats = _category_scores(records)
    out = {f"mme_{c}": s for c, s in sorted(cats.items())}
    out["mme_perception_score"] = sum(
        s for c, s in cats.items() if c in PERCEPTION)
    out["mme_cognition_score"] = sum(
        s for c, s in cats.items() if c in COGNITION)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/MME", data_root, split)


register_task(Task(
    name="mme",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # mme.yaml:10
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    # positional doc ids: MME's question_id is the IMAGE id, shared by the
    # two questions of a pair (utils.py:109-116) — not unique per doc.
    # mme.yaml:11-16
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "top_p": 1.0, "num_beams": 1, "do_sample": False},
))
