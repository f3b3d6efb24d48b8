"""FunQA counter-intuitive video QA (funqa_test) — BLEU/ROUGE metrics.

Parity: lmms_eval/tasks/funqa/ — docs carry video_name / question /
answer / task (one of H2 H3 H4 C2 C3 C4 M2 M3: humor, creative, magic
subtasks). Prompt is the bare question (utils.py:241-243). Scoring ports
the two deterministic metrics (utils.py:131-165, 303-330): per-sample
coco BLEU-4 and ROUGE-L against the single reference answer, collected
into the FIXED 8-task dict and averaged as mean-of-task-means — absent
tasks contribute 0 and the denominator stays 8, exactly as the
reference's scores_dict does. The GPT-judge and BLEURT metrics are
external-model dependencies (gpt-4 API, lucadiliello/BLEURT-20) and are
not ported; submission-file writing is covered by the harness's
per-sample logs.
"""

from __future__ import annotations

import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import bleu_scores, ptb_tokenize, rouge_l

TASK_KEYS = ("H2", "H3", "H4", "C2", "C3", "C4", "M2", "M3")


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "videos") if data_root else "videos"
    path = os.path.join(base, doc["video_name"])
    if os.path.exists(path):
        return path
    alt = path.replace("mp4", "MP4")
    if os.path.exists(alt):
        return alt
    raise FileNotFoundError(path)


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = ""):
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    return {"pred": response if isinstance(response, str) else "",
            "answer": doc["answer"], "task": doc["task"]}


def _sample_bleu4(ref: str, hyp: str) -> float:
    gts = {0: [ptb_tokenize(ref)]}
    res = {0: [ptb_tokenize(hyp)]}
    return bleu_scores(gts, res)[3]


def _sample_rouge(ref: str, hyp: str) -> float:
    return rouge_l({0: [ptb_tokenize(ref)]}, {0: [ptb_tokenize(hyp)]})


def aggregate(records: List[dict]) -> Dict[str, float]:
    by_task: Dict[str, Dict[str, List[float]]] = {
        k: {"BLEU": [], "ROUGE": []} for k in TASK_KEYS}
    for r in records:
        if r["task"] in by_task:
            by_task[r["task"]]["BLEU"].append(
                _sample_bleu4(r["answer"], r["pred"]))
            by_task[r["task"]]["ROUGE"].append(
                _sample_rouge(r["answer"], r["pred"]))
    out: Dict[str, float] = {}
    for metric in ("BLEU", "ROUGE"):
        task_means = {k: (sum(v[metric]) / len(v[metric]) if v[metric]
                          else 0.0) for k, v in by_task.items()}
        # reference funqa_aggregate_results: mean over the fixed 8 keys
        out[f"funqa_{metric}"] = sum(task_means.values()) / len(task_means)
        for k, m in task_means.items():
            out[f"funqa_{metric}_{k}"] = m
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("fesvhtr/FunQA_LMMs", data_root, split)


register_task(Task(
    name="funqa_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="funqa_BLEU",
    generation_kwargs={"max_new_tokens": 256, "temperature": 0,
                       "do_sample": False},
))
