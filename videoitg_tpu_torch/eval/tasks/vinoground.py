"""Vinoground counterfactual temporal video-text grounding.

Parity: lmms_eval/tasks/vinoground/ (vinoground.yaml + utils.py). Each of
500 caption pairs yields FOUR docs: {idx}_{pos|neg}_{text|video} — a
text-score question (pick the caption matching the video) and a
video-score question (pick the video matching the caption), each asked
for the positive and the negative pairing. Docs carry index / question /
GT / video_name / major / minor (reference keeps question+GT in side-car
score JSONs, utils.py:23-37; this port expects them inline per doc).

Scoring (utils.py:61-135): first prediction character vs GT, then a
500x7 matrix — text = pos AND neg correct on the text question, video =
pos AND neg on the video question, group = text AND video — reported as
percentage means plus per-major-category rollups.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

POST_PROMPT = "\nPlease only output one English character."  # utils.py:59


def doc_to_visual(doc, data_root: str = ""):
    path = (os.path.join(data_root, doc["video_name"]) if data_root
            else doc["video_name"])
    if os.path.exists(path):
        return path
    raise FileNotFoundError(path)


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = POST_PROMPT):
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    parts = str(doc["index"]).split("_")
    pair_id, polarity, question_type = int(parts[0]), parts[1], parts[2]
    pred = response.strip() if isinstance(response, str) else str(response)
    correct = bool(pred) and pred[0].lower() == str(doc["GT"]).lower()
    categories = ["all", doc.get("major", "unknown")]
    if doc.get("minor"):
        categories.extend(str(doc["minor"]).split(";"))
    return {
        "pair_id": pair_id,
        "polarity": polarity,          # pos | neg
        "question_type": question_type,  # text | video
        "correct": int(correct),
        "categories": categories,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"vinoground_text": 0.0, "vinoground_video": 0.0,
                "vinoground_group": 0.0}
    # cell[(pair, type, polarity)] = correct; AND across polarities, then
    # across question types (reference's 500x7 matrix, utils.py:75-106).
    cell: Dict[tuple, int] = {}
    cats: Dict[int, List[str]] = {}
    for r in records:
        cell[(r["pair_id"], r["question_type"], r["polarity"])] = r["correct"]
        cats.setdefault(r["pair_id"], r["categories"])
    pairs = sorted(cats)
    text = {p: cell.get((p, "text", "pos"), 0) & cell.get((p, "text", "neg"), 0)
            for p in pairs}
    video = {p: cell.get((p, "video", "pos"), 0) & cell.get((p, "video", "neg"), 0)
             for p in pairs}
    group = {p: text[p] & video[p] for p in pairs}

    def pct(d):
        return 100.0 * sum(d.values()) / len(d) if d else 0.0

    out = {"vinoground_text": pct(text), "vinoground_video": pct(video),
           "vinoground_group": pct(group)}
    by_cat = defaultdict(list)
    for p in pairs:
        for c in cats[p]:
            by_cat[c].append(p)
    for c in sorted(by_cat):
        if c == "all":
            continue
        sub = by_cat[c]
        out[f"vinoground_{c}_text"] = 100.0 * sum(text[p] for p in sub) / len(sub)
        out[f"vinoground_{c}_video"] = 100.0 * sum(video[p] for p in sub) / len(sub)
        out[f"vinoground_{c}_group"] = 100.0 * sum(group[p] for p in sub) / len(sub)
    return out


def load_docs(data_root: str, split: str = "lmmseval") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("HanSolo9682/Vinoground", data_root, split)


register_task(Task(
    name="vinoground",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="vinoground_group",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
