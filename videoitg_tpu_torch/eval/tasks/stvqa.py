"""ST-VQA test (parity: lmms_eval/tasks/stvqa/utils.py, stvqa.yaml).

Image task, submission-only: the test split withholds answers; each
sample record carries {"question_id": int(qid), "answer": raw response}
exactly as the upstream submission JSON rows (utils.py:19-21 — note the
RAW response, no EvalAI normalization, and the int() cast on the id).
Prompt: raw question + "\\nAnswer the question using a single word or
phrase." (stvqa.yaml:16-19).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = ("\nAnswer the question using a single "
                                    "word or phrase.")) -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    return {"question_id": int(doc["question_id"]),  # utils.py:21
            "answer": response}


def aggregate(records: List[dict]) -> Dict[str, float]:
    return {"submission_rows": float(len(records))}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/ST-VQA", data_root, split)


register_task(Task(
    name="stvqa",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),  # stvqa.yaml:8
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="question_id",
    generation_kwargs={"max_new_tokens": 32, "temperature": 0,
                       "do_sample": False},
))
