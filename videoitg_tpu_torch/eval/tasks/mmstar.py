"""MMStar image benchmark (parity: lmms_eval/tasks/mmstar/utils.py,
mmstar.yaml).

Image task (stills through the downstream adapters): docs carry index /
image (path relative to data_root; the reference's HF split embeds PIL) /
question (choices embedded) / answer (letter) / category (one of the six
L1 dimensions) / l2_category (18 sub-dimensions, 3 per L1).

Scoring parity:
- the MMStar matcher (utils.py:40-55): gold letter vs the prediction's
  first char, or "(X)", or "option X", or "the answer is X" — lowered,
  stripped, newlines flattened; anything else scores 0 (an empty
  prediction hits the try/except and scores 0).
- aggregation (utils.py:57-95): records group by L1 category; within one,
  scores average per l2_category first, and the category score is the
  mean of its l2 means (so unevenly-sized sub-dimensions weigh equally);
  "average" applies the same l2-grouped mean over ALL records.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

L1_CATEGORIES = [
    "coarse perception", "fine-grained perception", "instance reasoning",
    "logical reasoning", "science & technology", "math",
]

REPLACE_PROMPT = " Please answer yes or no."  # utils.py:22 (vestigial)


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(
    doc, pre_prompt: str = "",
    post_prompt: str = ("\nAnswer with the option's letter from the given "
                        "choices directly"),
) -> str:
    # utils.py:29-37 with the yaml default kwargs (mmstar.yaml:41-44)
    question = doc["question"].strip()
    if pre_prompt:
        question = pre_prompt + question.replace(REPLACE_PROMPT, "")
    if post_prompt:
        question = question.replace(REPLACE_PROMPT, "") + post_prompt
    return question


def exact_match(pred: str, gt: str) -> float:
    """utils.py:40-55 verbatim semantics (incl. the swallow-everything
    try/except that zeroes empty/short predictions)."""
    answer = gt.lower().strip().replace("\n", " ")
    predict = pred.lower().strip().replace("\n", " ")
    try:
        if answer == predict[0]:
            return 1.0
        elif predict[0] == "(" and answer == predict[1]:
            return 1.0
        elif predict[0:7] == "option " and answer == predict[7]:
            return 1.0
        elif predict[0:14] == "the answer is " and answer == predict[14]:
            return 1.0
    except Exception:
        return 0.0
    return 0.0


def process_results(doc, response: str) -> dict:
    return {
        "question_id": doc["index"],
        "category": doc["category"],
        "l2_category": doc["l2_category"],
        "score": exact_match(response, doc["answer"]),
    }


def _l2_grouped_mean(records: List[dict]) -> float:
    by_l2 = defaultdict(list)
    for r in records:
        by_l2[r["l2_category"]].append(r["score"])
    if not by_l2:
        return 0.0
    means = [sum(v) / len(v) for v in by_l2.values()]
    return sum(means) / len(means)


def aggregate(records: List[dict]) -> Dict[str, float]:
    out = {}
    for cat in L1_CATEGORIES:
        cat_recs = [r for r in records if r["category"] == cat]
        if cat_recs:
            out[f"mmstar_{cat}"] = _l2_grouped_mean(cat_recs)
    out["mmstar_average"] = _l2_grouped_mean(records)
    return out


def load_docs(data_root: str, split: str = "val") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("Lin-Chen/MMStar", data_root, split)


register_task(Task(
    name="mmstar",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # mmstar.yaml:9
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="index",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
