"""Perception Test (val) multiple-choice tasks.

Parity: lmms_eval/tasks/perceptiontest/val/ — docs carry video_name /
question / options (<=3: A-C) / answer_id / area / reasoning / tag.

* perceptiontest_val_mc — generation: the question plus lettered options
  and the fixed "Answer with the option's letter..." post prompt
  (utils.py:49-72); predictions are parsed with the \\b([A-D])\\b regex and
  scored against answer_id (utils.py:110-136); metric = accuracy
  (utils.py:139-149), reported on the 0-100 scale like our other tasks.
* perceptiontest_val_mcppl — candidate loglikelihood (the reference's
  perceptiontest_mcppl.yaml): each doc expands to one request per option,
  the option text is the continuation, and aggregation argmins/argmaxes
  per question (utils.py:80-105 picks the LOWEST value because the
  reference feeds losses; we use loglikelihoods, so highest wins — same
  ordering).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

LETTERS = "ABCD"


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "videos") if data_root else "videos"
    path = os.path.join(base, doc["video_name"] + ".mp4")
    for cand in (path, path.replace("mp4", "MP4")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    question = doc["question"]
    if "options" in doc:
        for i, op in enumerate(doc["options"]):
            question += "\n" + LETTERS[min(i, 2)] + ". " + op
        post_prompt = "\nAnswer with the option's letter from the given choices directly."
    return f"{pre_prompt}{question}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response.strip()
    m = re.search(r"\b([A-D])\b", pred)
    index = {"A": 0, "B": 1, "C": 2, "D": 3}.get(
        m.group(1).upper() if m else "", -1)
    return {
        "video_name": doc["video_name"],
        "question_id": doc.get("question_id"),
        "area": doc.get("area"),
        "tag": doc.get("tag"),
        "pred_id": index,
        "answer_id": int(doc["answer_id"]),
        "correct": int(index == int(doc["answer_id"])),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"perceptiontest_accuracy": 0.0}
    return {"perceptiontest_accuracy":
            100.0 * sum(r["correct"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "validation") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    # reference perceptiontest_mc.yaml names dataset_name "mc_question_val"
    return load_benchmark_docs("lmms-lab/PerceptionTest_Val", data_root,
                               split, subset="mc_question_val")


register_task(Task(
    name="perceptiontest_val_mc",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="perceptiontest_accuracy",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))


# ---- mcppl: per-option loglikelihood (shared machinery) -----------------

from videoitg_tpu_torch.eval.mc_loglikelihood import make_mc_ll_suite

ll_expand_docs, ll_doc_to_target, ll_process_results, ll_aggregate = (
    make_mc_ll_suite(
        qid_of=lambda d: d.get("question_id", d["video_name"]),
        n_options_of=lambda d: len(d["options"]),
        option_text_of=lambda d, i: d["options"][i],
        answer_index_of=lambda d: d["answer_id"],
        metric_prefix="perceptiontest_ll",
    ))


def ll_doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "\nAnswer:") -> str:
    return f"{pre_prompt}{doc['question'].strip()}{post_prompt}"


def ll_load_docs(data_root: str, split: str = "validation") -> List[dict]:
    return ll_expand_docs(load_docs(data_root, split))


register_task(Task(
    name="perceptiontest_val_mcppl",
    doc_to_visual=doc_to_visual,
    doc_to_text=ll_doc_to_text,
    doc_to_target=ll_doc_to_target,
    output_type="loglikelihood",
    process_results=ll_process_results,
    aggregate=ll_aggregate,
    load_docs=ll_load_docs,
    doc_id_key="_ll_id",
    primary_metric="perceptiontest_ll_acc",
))
