"""ConBench (parity: lmms_eval/tasks/conbench/utils.py +
conbench.yaml).

Consistency benchmark over ConBench/ConBench_D test: every image is
asked THREE questions about the same fact in different formats
(question_field N/Y, Choices, Q/A) and the ConScore_D metric is the
share of images where ALL THREE are answered correctly.

Parity (utils.py:26-96):
* doc_to_text: the raw stripped question.
* prediction parsing: responses are lowercased with newlines removed;
  N/Y uses the MME-style 4-char prefix rule; Choices takes the first
  non-space character; Q/A keeps the text.
* scoring: Q/A fields pass via ANLS at threshold 0.95 (the similarity
  must clear 0.95 to be nonzero; the >= 0.4 comparison is then
  equivalent) — ANLS computed in-module on the normalized strings;
  other fields need exact equality with the lowercased gold.
* ConScore_D: count images whose per-image score sums to 3, divided
  by (#records / 3).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import levenshtein_distance


def parse_pred_ans_NY(pred: str) -> str:
    """utils.py:26-39 (pred already lowercased)."""
    if pred in ("yes", "no"):
        return pred
    prefix = pred[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def parse_pred_ans_choice(pred: str) -> str:
    """utils.py:42-43 — first non-space char ('' stays '')."""
    squeezed = pred.replace(" ", "")
    return squeezed[0] if squeezed else ""


def _anls_ok(pred: str, gold: str, threshold: float = 0.95) -> bool:
    """anls_score(prediction, [gold], threshold=0.95) >= 0.4: the
    similarity is zeroed below the threshold, so this reduces to
    similarity >= 0.95 (0.95 > 0.4)."""
    if not gold and not pred:
        return True
    denom = max(len(gold), len(pred))
    if denom == 0:
        return False
    sim = 1 - levenshtein_distance(gold, pred) / denom
    return sim >= threshold


def doc_to_text(doc) -> str:
    return doc["question"].strip()


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    pred = response.replace("\n", "").lower()
    field = doc["question_field"]
    if field == "N/Y":
        pred_ans = parse_pred_ans_NY(pred)
    elif field == "Choices":
        pred_ans = parse_pred_ans_choice(pred)
    else:
        pred_ans = pred
    gt = doc["answer"].lower()
    score = 1 if ((field == "Q/A" and _anls_ok(pred_ans, gt))
                  or gt == pred_ans) else 0
    return {"image_id": doc["image_id"], "question_field": field,
            "score": score}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"ConScore_D": 0.0}
    per_image: Dict[str, int] = defaultdict(int)
    for r in records:
        per_image[r["image_id"]] += r["score"]
    consistent = sum(1 for v in per_image.values() if v == 3)
    return {"ConScore_D": consistent / (len(records) / 3)}


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("ConBench/ConBench_D", data_root, split)


register_task(Task(
    name="conbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="ConScore_D",
    load_docs=_load,
    generation_kwargs={"max_new_tokens": 128, "temperature": 0,
                       "do_sample": False},
))
