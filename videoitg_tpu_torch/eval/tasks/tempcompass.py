"""TempCompass temporal-understanding tasks (mc / yes_no / caption_matching).

Parity: lmms_eval/tasks/tempcompass/ — docs carry video_id / question /
answer / dim (the temporal dimension: action, direction, speed, order,
attribute_change). Prompts are the bare question plus the per-subtask post
prompt the reference's YAML provides through lmms_eval_specific_kwargs
(tempcompass_*.yaml); scoring is the reference's hand-crafted matching:

* multi-choice: exact answer, bare letter, "A."/"A)" prefixes
  (utils.py:127-143);
* yes_no: lowercase startswith yes/no (utils.py:461-469);
* caption_matching: option-string/sentence/index matching
  (utils.py:438-458).

The reference falls back to a ChatGPT judge when rules fail to match
(utils.py:144-152) — an external-API dependency this rebuild replaces with
rating 0 + match_success=False in the record (the unmatched rate is
visible in the per-sample logs; no silent scoring difference when rules
match). The captioning subtask is judge-ONLY and is not ported. Metrics:
avg accuracy + per-dim rollups, 0-100 scale.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

POST_PROMPTS = {
    # reference _default_template_yaml lmms_eval_specific_kwargs post_prompt
    "multi-choice": "\nPlease directly give the best option:",
    "yes_no": "\nPlease answer yes or no:",
    "caption_matching": "\nPlease directly give the best option:",
}


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "videos") if data_root else "videos"
    path = os.path.join(base, str(doc["video_id"]) + ".mp4")
    if os.path.exists(path):
        return path
    raise FileNotFoundError(path)


def _doc_to_text(kind):
    def fn(doc, pre_prompt: str = "", post_prompt: str = POST_PROMPTS[kind]):
        return f"{pre_prompt}{doc['question']}{post_prompt}"

    return fn


def _record(doc, pred, rating: int, match_success: bool) -> dict:
    return {
        "video_id": doc["video_id"],
        "gt-answer": doc["answer"],
        "video-llm-prediction": pred,
        "match_success": match_success,
        "rating": rating,
        "dim": doc.get("dim", "unknown"),
    }


def process_results_mc(doc, response: str) -> dict:
    pred = response.strip() if isinstance(response, str) else response
    answer = doc["answer"]
    if pred == answer:
        return _record(doc, pred, 1, True)
    if pred in ("A", "B", "C", "D"):
        return _record(doc, pred, int(pred == answer[0]), True)
    for sep in (".", ")"):
        if any(pred.startswith(f"{ltr}{sep}") for ltr in "ABCD"):
            return _record(doc, pred, int(pred.split(sep)[0] == answer[0]), True)
    return _record(doc, pred, 0, False)


def process_results_yes_no(doc, response: str) -> dict:
    low = response.strip().lower()
    pred = "yes" if low.startswith("yes") else ("no" if low.startswith("no") else None)
    if pred is None:
        return _record(doc, response, 0, False)
    return _record(doc, response, int(pred == doc["answer"]), True)


def process_results_caption_matching(doc, response: str) -> dict:
    out = response.strip()
    question, answer = doc["question"], doc["answer"]
    option_strs = question.split("\n")[1:]
    option_sents = [o.split(": ", 1)[1] for o in option_strs if ": " in o]
    option_inds = [o.split(": ")[0] for o in option_strs] + [
        o.split(": ")[0].replace("Sentence ", "").replace("Option ", "")
        .replace("Caption ", "") for o in option_strs]
    pred = None
    for o in option_strs:
        if o == out:
            pred = o
    for s in option_sents:
        if s == out or (") " in out and s == out.split(") ", 1)[1]):
            pred = s
    for ind in option_inds:
        if ind == out or ind == out.replace(".", ""):
            pred = ind
    if pred is None:
        return _record(doc, out, 0, False)
    ok = (pred == answer or pred == answer.split(":")[0]
          or (": " in answer and pred == answer.split(": ", 1)[1])
          or pred == answer.split(": ")[0].split()[-1])
    return _record(doc, out, int(ok), True)


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"tempcompass_accuracy": 0.0}
    by_dim = defaultdict(list)
    for r in records:
        by_dim[r["dim"]].append(r["rating"])
    out = {"tempcompass_accuracy":
           100.0 * sum(r["rating"] for r in records) / len(records),
           "tempcompass_match_rate":
           100.0 * sum(r["match_success"] for r in records) / len(records)}
    for dim, ratings in sorted(by_dim.items()):
        out[f"tempcompass_{dim}"] = 100.0 * sum(ratings) / len(ratings)
    return out


def _load(subset):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(
            "lmms-lab/TempCompass", data_root, split, subset=subset)

    return load_docs


for _name, _kind, _proc in (
        ("tempcompass_multi_choice", "multi-choice", process_results_mc),
        ("tempcompass_yes_no", "yes_no", process_results_yes_no),
        ("tempcompass_caption_matching", "caption_matching",
         process_results_caption_matching)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_doc_to_text(_kind),
        process_results=_proc,
        aggregate=aggregate,
        load_docs=_load(_kind),
        doc_id_key=None,
        primary_metric="tempcompass_accuracy",
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
    ))

register_group("tempcompass", ["tempcompass_multi_choice",
                               "tempcompass_yes_no",
                               "tempcompass_caption_matching"])
