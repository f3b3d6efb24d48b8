"""OK-VQA val2014 (parity: lmms_eval/tasks/ok_vqa/utils.py +
_default_template_vqa_yaml, ok_vqa_val2014.yaml).

Image task: docs carry question_id / question / answers (annotator
strings) / image. Scoring is the standard EvalAI leave-one-out VQA
accuracy (eval/vqa_answer.vqa_accuracy; utils.py:19-47 is line-for-line
the textvqa flow). The submission row upstream maps question_id to an
"image" filename f"{question_id}.jpg" (utils.py:44-46) — preserved in
the per-sample record.

Prompt (template lmms_eval_specific_kwargs.default): raw question +
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
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    answers = doc.get("answers") or []
    if isinstance(answers, str):
        answers = [answers]
    return {
        "question_id": doc["question_id"],
        "image": f"{doc['question_id']}.jpg",  # utils.py:44-46
        "pred": vqa_normalize(response),
        "exact_match": vqa_accuracy(response, answers),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"ok_vqa_exact_match": 0.0}
    return {"ok_vqa_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "val2014") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/OK-VQA", data_root, split)


register_task(Task(
    name="ok_vqa_val2014",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="question_id",
    generation_kwargs={"temperature": 0, "do_sample": False,
                       "until": ["ASSISTANT:"]},
))
