"""ICON-QA (parity: lmms_eval/tasks/iconqa/utils.py +
_default_template_docvqa_yaml + iconqa_{val,test}.yaml; group iconqa).

Abstract-diagram QA over lmms-lab/ICON-QA val/test. Three question
types (utils.py:27-50):

* choose_img — the query image plus two candidate images; the options
  are the fixed strings "The first image." / "The second image.".
* choose_txt — comma-joined doc["choices"] rendered as "A. x" lines.
* fill_in_blank — free-form, "single word or phrase" statement.

Visuals (utils.py:15-24): query_image followed by choice_image_0..4
when present (multi-image docs ride the adapter's PIL/path list
branch).

Scoring: ANLS against the doc's answer(s) — the vendored template's
only active metric (the commented test_process_results shows the same
{answer, pred} payload; aggregation "mean"). eval/metrics.anls is the
shared implementation (docvqa parity-tested).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import anls

STATEMENT = ("Given a set of images and a question, please provide the "
             "answer to the question.\n")
OPTIONS_STATEMENT = ("Question: {question}.\nOptions:\n{options}\nPlease "
                     "answer with the option letter from the given choices "
                     "directly.")
FREEFORM_STATEMENT = ("Question: {question}.\nPlease answer the question "
                      "using a single word or phrase.")


def options_to_str(options: List[str]) -> str:
    return "\n".join(f"{chr(ord('A') + i)}. {o}"
                     for i, o in enumerate(options))


def doc_to_text(doc, pre_prompt: str = "", statement: str = STATEMENT,
                options_statement: str = OPTIONS_STATEMENT,
                freeform_statement: str = FREEFORM_STATEMENT) -> str:
    q, qt = doc["question"], doc["ques_type"]
    if qt == "choose_img":
        options = options_to_str(["The first image.", "The second image."])
        body = options_statement.format(question=q, options=options)
    elif qt == "choose_txt":
        options = options_to_str(doc["choices"].split(","))
        body = options_statement.format(question=q, options=options)
    elif qt == "fill_in_blank":
        body = freeform_statement.format(question=q)
    else:
        raise ValueError(f"unknown ques_type {qt!r}")
    return f"{pre_prompt}{statement}{body}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    def resolve(v):
        if hasattr(v, "convert"):
            return v
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        return p

    out = []
    if doc.get("query_image") is not None:
        out.append(resolve(doc["query_image"]))
    for i in range(5):
        v = doc.get(f"choice_image_{i}")
        if v is not None:
            out.append(resolve(v))
    assert len(out) < 6, "Maximum 5 images allowed for ICON-QA"
    return out


def process_results(doc, response: str) -> dict:
    answers = doc.get("answers", doc.get("answer"))
    if isinstance(answers, str):
        answers = [answers]
    return {"question_id": doc.get("question_id"),
            "answer": answers, "pred_answer": response,
            "anls": anls(answers, response)}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"iconqa_anls": 0.0}
    return {"iconqa_anls":
            sum(r["anls"] for r in records) / len(records)}


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/ICON-QA", data_root, split_)
    return load_docs


for _split in ("val", "test"):
    register_task(Task(
        name=f"iconqa_{_split}",
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answers", doc.get("answer")),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="iconqa_anls",
        load_docs=_make_load(_split),
        doc_id_key="question_id",
        generation_kwargs={"max_new_tokens": 32, "temperature": 0,
                           "do_sample": False},
    ))
