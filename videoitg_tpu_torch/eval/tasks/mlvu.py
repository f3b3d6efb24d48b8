"""MLVU + MLVU-dev tasks (parity: lmms_eval/tasks/mlvu/utils.py).

Docs carry video_name / question / answer / task_type. Prompt appends
"Only give the best option." and "Best option: (" (utils.py:57-62);
accuracy is averaged per task_type then overall (M-avg convention).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.extraction import extract_choice_letter

TASK_TYPES = ["TR", "AR", "VS", "NQA", "ER", "PQA", "SSC", "AO", "AC"]


def doc_to_visual(doc, data_root: str = ""):
    p = os.path.join(data_root, doc["video_name"]) if data_root else doc["video_name"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, **_):
    question = doc["question"] + "\nOnly give the best option.\n"
    return "\n" + question + "\n" + "Best option: ("


def process_results(doc, response: str) -> dict:
    return {
        "task_type": doc.get("task_type"),
        "pred_answer": extract_choice_letter(response),
        "answer": doc["answer"],
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    by_type = defaultdict(lambda: [0, 0])
    for r in records:
        ok = int(r["pred_answer"] == r["answer"])
        by_type[r["task_type"]][0] += ok
        by_type[r["task_type"]][1] += 1
    out: Dict[str, float] = {}
    per_type = []
    for t, (c, a) in sorted(by_type.items()):
        score = 100.0 * c / a if a else 0.0
        out[f"mlvu_{t}"] = score
        per_type.append(score)
    total_c = sum(v[0] for v in by_type.values())
    total_a = sum(v[1] for v in by_type.values())
    out["mlvu_perception_score"] = 100.0 * total_c / total_a if total_a else 0.0
    out["mlvu_m_avg"] = sum(per_type) / len(per_type) if per_type else 0.0
    return out


def _load(split):
    def load_docs(data_root: str, split_=split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/MLVU", data_root, split_)

    return load_docs


for name, split in [("mlvu", "test"), ("mlvu_dev", "dev")]:
    register_task(Task(
        name=name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results,
        aggregate=aggregate,
        load_docs=_load(split),
        primary_metric="mlvu_perception_score",
        generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
    ))
