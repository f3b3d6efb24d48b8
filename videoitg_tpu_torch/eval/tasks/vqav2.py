"""VQAv2 benchmark (parity: lmms_eval/tasks/vqav2/utils.py +
_default_template_vqav2_yaml, vqav2_val.yaml / vqav2_test.yaml).

Image task: docs carry question_id / question / answers (annotator dicts
with "answer" [+ answer_id/answer_confidence]; absent on the test
split) / image (path relative to data_root; the reference HF split
embeds PIL, utils.py:13-14).

Scoring parity: eval/vqa_answer.vqa_accuracy_v2 — VQAv2's variant of the
leave-one-out accuracy with the conditional second normalization pass,
dict-inequality exclusion, and the unanimous-gold no-normalize quirk,
all fuzz-verified against the vendored utils.py (see its docstring).
vqav2_val scores accuracy only (vqav2_val.yaml:4-10); vqav2_test is
submission-only (vqav2_test.yaml:4-8) — both carry the normalized
prediction per sample, mirroring the submission JSON rows
(utils.py:45-50).

Prompt (utils.py:68-78 + template defaults): raw question + "\\nAnswer
the question using a single word or phrase.".
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.vqa_answer import vqa_accuracy_v2


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
    acc, norm = vqa_accuracy_v2(response, doc.get("answers") or [])
    return {
        "question_id": doc["question_id"],
        "pred": norm,  # submission payload (utils.py:47-50)
        "exact_match": acc,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"vqav2_exact_match": 0.0}
    return {"vqav2_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    # test split is submission-only (vqav2_test.yaml): the per-sample rows
    # (question_id + normalized pred) are the deliverable, mirroring
    # vqav2_aggregate_submissions' JSON dump (utils.py:81-87).
    return {"submission_rows": float(len(records))}


def _make_load_docs(default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/VQAv2", data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 16, "temperature": 0, "do_sample": False}

register_task(Task(
    name="vqav2_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answers"),  # template doc_to_target
    process_results=process_results,
    aggregate=aggregate,
    load_docs=_make_load_docs("validation"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="vqav2_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=_aggregate_submission,
    load_docs=_make_load_docs("test"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))
