"""VizWiz-VQA (parity: lmms_eval/tasks/vizwiz_vqa/utils.py +
_default_template_vqa_yaml, vizwiz_vqa_val.yaml / vizwiz_vqa_test.yaml).

Image task: docs carry question_id / question / answers (annotator
strings; withheld on test) / image. Scoring is the standard EvalAI
leave-one-out VQA accuracy (eval/vqa_answer.vqa_accuracy;
utils.py:19-47). The val yaml's submission metric is commented out
upstream — val scores accuracy only; test is submission-only, with the
upstream row shape {"image": f"{question_id}.jpg", "answer": <norm>}
(utils.py:43-46) preserved per sample.

Prompt (utils.py:51-62 + template defaults): ``question.capitalize()`` +
"\\nWhen the provided information is insufficient, respond with
'Unanswerable'.\\nAnswer the question using a single word or phrase.".
Stop string "ASSISTANT:".
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.vqa_answer import vqa_accuracy, vqa_normalize

POST_PROMPT = ("\nWhen the provided information is insufficient, respond "
               "with 'Unanswerable'.\nAnswer the question using a single "
               "word or phrase.")


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    return f"{pre_prompt}{doc['question'].capitalize()}{post_prompt}"


def process_results(doc, response: str) -> dict:
    answers = doc.get("answers") or []
    if isinstance(answers, str):
        answers = [answers]
    return {
        "question_id": doc["question_id"],
        "image": f"{doc['question_id']}.jpg",  # utils.py:43-46
        "pred": vqa_normalize(response),
        "exact_match": vqa_accuracy(response, answers),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"vizwiz_vqa_exact_match": 0.0}
    return {"vizwiz_vqa_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    return {"submission_rows": float(len(records))}


def _make_load_docs(default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/VizWiz-VQA", data_root, split)
    return load_docs


_GEN = {"temperature": 0, "do_sample": False, "until": ["ASSISTANT:"]}

register_task(Task(
    name="vizwiz_vqa_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),
    process_results=process_results,
    aggregate=aggregate,
    load_docs=_make_load_docs("val"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="vizwiz_vqa_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=_aggregate_submission,
    load_docs=_make_load_docs("test"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))
