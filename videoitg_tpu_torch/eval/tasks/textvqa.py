"""TextVQA benchmark (parity: lmms_eval/tasks/textvqa/utils.py +
_default_template_textvqa_yaml, textvqa_val.yaml / textvqa_test.yaml).

Image task: docs carry question_id / question / answers (10 annotator
strings; absent on the submission-only test split) / image (path
relative to data_root; the reference HF split embeds PIL,
utils.py:15-16) / ocr_tokens.

Scoring parity (utils.py:19-44): prediction and all annotator answers
are EvalAI-normalized (eval/vqa_answer.py), then the official VQA
leave-one-out accuracy applies — per annotator min(1, matches-among-
others / 3), averaged. The submission row carries the NORMALIZED
prediction (utils.py:39-42), on both splits.

Prompt parity (utils.py:47-59 with the template defaults): the question
is ``.capitalize()``-d; ``ocr=True`` (a yaml variant) appends
"\\nReference OCR token: <comma-joined tokens>" before the post prompt.
The qwen_vl variant (post_prompt " Answer:") is reachable via
prompt_overrides. Stop string "ASSISTANT:" per the template's
generation_kwargs.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.vqa_answer import vqa_accuracy, vqa_normalize


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = ("\nAnswer the question using a single "
                                    "word or phrase."),
                ocr: bool = False) -> str:
    ocr_ref = ""
    if ocr:
        ocr_ref = f"\nReference OCR token: {', '.join(doc['ocr_tokens'])}"
    return f"{pre_prompt}{doc['question'].capitalize()}{ocr_ref}{post_prompt}"


def process_results(doc, response: str) -> dict:
    answers = doc.get("answers") or []
    if isinstance(answers, str):
        answers = [answers]
    return {
        "question_id": doc["question_id"],
        "pred": vqa_normalize(response),  # submission payload, normalized
        "exact_match": vqa_accuracy(response, answers),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"textvqa_exact_match": 0.0}
    return {"textvqa_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    # test split is submission-only (textvqa_test.yaml:3-6): answers are
    # withheld upstream; the per-sample rows in samples.jsonl (question_id
    # + normalized pred) ARE the deliverable, mirroring
    # textvqa_aggregate_submissions' JSON dump (utils.py:62-67).
    return {"submission_rows": float(len(records))}


def _make_load_docs(default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/textvqa", data_root, split)
    return load_docs


register_task(Task(
    name="textvqa_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),  # template doc_to_target
    process_results=process_results,
    aggregate=aggregate,
    load_docs=_make_load_docs("validation"),
    doc_id_key="question_id",
    prompt_overrides={"qwen-vl-chat": {"post_prompt": " Answer:"}},
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False, "until": ["ASSISTANT:"]},
))

register_task(Task(
    name="textvqa_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=_aggregate_submission,
    load_docs=_make_load_docs("test"),
    doc_id_key="question_id",
    prompt_overrides={"qwen-vl-chat": {"post_prompt": " Answer:"}},
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False, "until": ["ASSISTANT:"]},
))
