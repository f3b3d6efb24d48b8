"""TemporalBench fine-grained temporal QA (short_qa / long_qa).

Parity: lmms_eval/tasks/temporalbench/ (temporalbench_short_qa.yaml,
temporalbench_long_qa.yaml + utils.py). Docs carry idx / video_name /
question / GT ("A"/"B") / dataset, optionally a numeric category. Scoring
(utils.py:90-112): a prediction is correct when its FIRST character
case-insensitively equals the ground-truth letter. Aggregation
(utils.py:90-200):

* binary accuracy — per-question mean;
* multiple-binary accuracy — a video counts only if ALL of its binary
  questions are correct (AND over video_name);
* per-dataset and per-category rollups of both.

The short_caption subtask requires a sentence-transformers CUDA embedding
model (utils.py:53-87) — an external-model judge this rebuild does not
port (same policy as tempcompass's judge-only captioning subtask).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

# reference utils.py:181-190
CATEGORY_NAMES = {
    1: "Action Order",
    2: "Action Frequency",
    3: "Action Type",
    4: "Motion Magnitude",
    5: "Motion Direction/Orientation",
    6: "Action Effector",
    7: "Others",
    8: "Event Order",
}


def doc_to_visual(doc, data_root: str = ""):
    path = os.path.join(data_root, doc["video_name"]) if data_root else doc["video_name"]
    if os.path.exists(path):
        return path
    raise FileNotFoundError(path)


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = ""):
    # reference utils.py:44-45: the bare question, no template
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response.strip() if isinstance(response, str) else str(response)
    correct = bool(pred) and pred[0].lower() == str(doc["GT"]).lower()
    return {
        "idx": doc.get("idx"),
        "video_name": doc["video_name"],
        "dataset": doc.get("dataset", "unknown"),
        "category": doc.get("category", ""),
        "gt": doc["GT"],
        "pred": pred,
        "correct": int(correct),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"temporalbench_binary_accuracy": 0.0}
    per_video: Dict[str, bool] = {}
    by_dataset = defaultdict(list)
    mba_by_dataset: Dict[str, Dict[str, bool]] = defaultdict(dict)
    by_category = defaultdict(list)
    mba_by_category: Dict[str, Dict[str, bool]] = defaultdict(dict)
    for r in records:
        ok = bool(r["correct"])
        vid = r["video_name"]
        per_video[vid] = per_video.get(vid, True) and ok
        ds = r["dataset"]
        by_dataset[ds].append(ok)
        mba_by_dataset[ds][vid] = mba_by_dataset[ds].get(vid, True) and ok
        if r.get("category") not in ("", None):
            cat = CATEGORY_NAMES.get(r["category"], str(r["category"]))
            by_category[cat].append(ok)
            mba_by_category[cat][vid] = mba_by_category[cat].get(vid, True) and ok

    def pct(xs):
        return 100.0 * sum(xs) / len(xs) if xs else 0.0

    out = {
        "temporalbench_binary_accuracy": pct([r["correct"] for r in records]),
        "temporalbench_multiple_binary_accuracy": pct(list(per_video.values())),
    }
    for ds in sorted(by_dataset):
        out[f"temporalbench_{ds}_ba"] = pct(by_dataset[ds])
        out[f"temporalbench_{ds}_mba"] = pct(list(mba_by_dataset[ds].values()))
    for cat in sorted(by_category):
        out[f"temporalbench_cat_{cat}_ba"] = pct(by_category[cat])
        out[f"temporalbench_cat_{cat}_mba"] = pct(list(mba_by_category[cat].values()))
    return out


def _load(split):
    def load_docs(data_root: str, split_arg: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(
            "microsoft/TemporalBench", data_root, split_arg)

    return load_docs


for _name, _split in (("temporalbench_short_qa", "test_short_qa"),
                      ("temporalbench_long_qa", "test_long_qa")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results,
        aggregate=aggregate,
        load_docs=_load(_split),
        doc_id_key=None,
        primary_metric="temporalbench_binary_accuracy",
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
    ))

register_group("temporalbench", ["temporalbench_short_qa",
                                 "temporalbench_long_qa"])
