"""SEED-Bench v1 (parity: lmms_eval/tasks/seedbench/utils.py,
seedbench.yaml + seedbench_ppl.yaml).

Mixed image/video benchmark scored as stills: docs carry question_id /
question / choice_a..choice_d / answer (a letter) / data_type ("image"
or "video") / image — a LIST of paths relative to data_root (the
reference's HF split embeds a PIL list, utils.py:4-5; its video
dimensions ship pre-extracted frames as that list). Multi-image docs
load through FrameSelectionConsumer's list branch.

Generation variant (utils.py:8-46): lettered choice lines + the letter
instruction; prediction is the stripped response's first char when
longer than 1; accuracy rolls up per data_type (seed_image/seed_video)
and overall (seed_all). The reference's aggregation also dumps
./seed_submission.json as a side effect (utils.py:38-45) — here the
per-sample predictions already land in samples.jsonl, so no extra file.

PPL variant (seedbench_ppl.yaml, lm-eval multiple_choice): prompt
"{question} Answer :" (utils.py:49-51), one loglikelihood request per
choice text, argmax per question (raw + length-normalized acc via the
shared mc-ll suite).
"""

from __future__ import annotations

import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.mc_loglikelihood import make_mc_ll_suite

_LETTERS = ["A", "B", "C", "D"]
_CHOICE_KEYS = ["choice_a", "choice_b", "choice_c", "choice_d"]


def doc_to_visual(doc, data_root: str = ""):
    paths = doc["image"]
    if isinstance(paths, str):
        paths = [paths]
    resolved = [os.path.join(data_root, p) if data_root else p
                for p in paths]
    for p in resolved:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    # single-image docs take the plain still branch; multi-image docs the
    # list branch (both in FrameSelectionConsumer.frames_for_doc)
    return resolved[0] if len(resolved) == 1 else resolved


def doc_to_text(doc) -> str:
    # utils.py:8-14
    question = doc["question"]
    question += "\n" + f"A. {doc['choice_a']}\n"
    question += f"B. {doc['choice_b']}\n"
    question += f"C. {doc['choice_c']}\n"
    question += f"D. {doc['choice_d']}"
    return (f"{question}\nAnswer with the option's letter from the given "
            "choices directly.")


def process_results(doc, response: str) -> dict:
    # utils.py:17-24
    pred = response.strip()
    if len(pred) > 1:
        pred = pred[0]
    return {
        "question_id": doc["question_id"],
        "data_type": doc["data_type"],
        "pred": pred,
        "answer": doc["answer"],
        "correct": float(pred.lower().strip()
                         == doc["answer"].lower().strip()),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    out = {}
    for key in ("image", "video"):
        sub = [r for r in records if r["data_type"] == key]
        if sub:
            out[f"seed_{key}"] = sum(r["correct"] for r in sub) / len(sub)
    if records:
        out["seed_all"] = sum(r["correct"] for r in records) / len(records)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/SEED-Bench", data_root, split)


register_task(Task(
    name="seedbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # seedbench.yaml:9
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="question_id",
    generation_kwargs={"until": ["ASSISTANT:"]},  # seedbench.yaml:11-13
))


(ll_expand_docs, ll_doc_to_target, ll_process_results, ll_aggregate) = (
    make_mc_ll_suite(
        qid_of=lambda d: d["question_id"],
        n_options_of=lambda d: 4,
        option_text_of=lambda d, i: d[_CHOICE_KEYS[i]],
        answer_index_of=lambda d: _LETTERS.index(d["answer"]),
        metric_prefix="seedbench_ll",
    ))


def ll_doc_to_text(doc) -> str:
    return f"{doc['question']} Answer :"  # utils.py:49-51


def ll_load_docs(data_root: str, split: str = "test") -> List[dict]:
    return ll_expand_docs(load_docs(data_root, split))


register_task(Task(
    name="seedbench_ppl",
    doc_to_visual=doc_to_visual,
    doc_to_text=ll_doc_to_text,
    doc_to_target=ll_doc_to_target,
    output_type="loglikelihood",
    process_results=ll_process_results,
    aggregate=ll_aggregate,
    load_docs=ll_load_docs,
    doc_id_key="_ll_id",
    primary_metric="seedbench_ll_acc",
))
