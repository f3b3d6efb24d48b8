"""MP-DocVQA / MultiDocVQA (parity: lmms_eval/tasks/multidocvqa/
utils.py + multidocvqa_{val,test}.yaml; group multidocvqa.yaml).

Multi-page document QA over lmms-lab/MP-DocVQA. Docs carry questionId /
question / answers (a list literal string) / image_1..image_20
(pages, None-padded).

Parity:
* doc_to_text (utils.py:12-17): question + "\\nAnswer the question
  using a single word or phrase.".
* visuals (utils.py:20-21): every non-None image_1..image_20 in order
  (multi-image docs ride the adapter's list branch).
* scoring (utils.py:65-111 Evaluator, case_sensitive=False): both
  metrics lowercase+strip; accuracy is exact membership with the
  "none" prediction hard-zeroed; ANLS is the max answer similarity
  (1 - edit_distance / max_len) gated at the 0.5 threshold, with
  empty and "none" predictions zeroed. This is a DIFFERENT anls
  variant from docvqa's (the "none" rule), hence implemented here
  rather than reusing eval/metrics.anls.
* test split is submission-only (answers withheld; rows carry
  questionId/answer/answer_page=None, utils.py:50-53).
"""

from __future__ import annotations

import ast
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import levenshtein_distance

POST_PROMPT = "\nAnswer the question using a single word or phrase."
ANLS_THRESHOLD = 0.5


def _prep(s: str) -> str:
    return s.lower().strip()


def calculate_accuracy(gt: List[str], pred: str) -> int:
    """utils.py:89-97."""
    if pred == "none":
        return 0
    return int(any(g == pred for g in gt))


def calculate_anls(gt: List[str], pred: str) -> float:
    """utils.py:99-110."""
    if len(pred) == 0 or pred == "none":
        return 0
    sims = [1 - levenshtein_distance(g, pred) / max(len(g), len(pred))
            for g in gt]
    best = max(sims)
    return best if best >= ANLS_THRESHOLD else 0


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    out = []
    for i in range(1, 21):
        v = doc.get(f"image_{i}")
        if v is None:
            continue
        if hasattr(v, "convert"):
            out.append(v)
            continue
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def _answers(doc) -> List[str]:
    a = doc["answers"]
    return ast.literal_eval(a) if isinstance(a, str) else list(a)


def process_results(doc, response: str) -> dict:
    gt = [_prep(a) for a in _answers(doc)]
    pred = _prep(response)
    return {"questionId": int(doc["questionId"]),
            "answer": _answers(doc), "pred_answer": response,
            "accuracy": calculate_accuracy(gt, pred),
            "anls": calculate_anls(gt, pred)}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"multidocvqa_anls": 0.0}
    n = len(records)
    return {"multidocvqa_anls": sum(r["anls"] for r in records) / n,
            "multidocvqa_accuracy":
                sum(r["accuracy"] for r in records) / n}


def process_results_test(doc, response: str) -> dict:
    """utils.py:50-53 — submission rows."""
    return {"questionId": int(doc["questionId"]), "answer": response,
            "answer_page": None}


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/MP-DocVQA", data_root, split_)
    return load_docs


_GEN = {"max_new_tokens": 32, "temperature": 0, "do_sample": False}

register_task(Task(
    name="multidocvqa_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="multidocvqa_anls",
    load_docs=_make_load("val"),
    doc_id_key="questionId",
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="multidocvqa_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results_test,
    aggregate=lambda rs: {"submission_rows": float(len(rs))},
    load_docs=_make_load("test"),
    doc_id_key="questionId",
    generation_kwargs=dict(_GEN),
))
