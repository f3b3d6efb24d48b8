"""DocVQA + InfoVQA validation splits (parity: lmms_eval/tasks/docvqa/
utils.py + _default_template_docvqa_yaml, lmms_eval/tasks/infovqa/
utils.py + _default_template_infovqa_yaml).

Image tasks: docs carry questionId / question / answers (list of
acceptable strings) / image (path relative to data_root). The two
benchmarks share one template — same prompt suffix, same ANLS scoring,
same hub dataset (lmms-lab/DocVQA) with subsets "DocVQA" /
"InfographicVQA" — so both register through one factory here.

Scored with ANLS (eval/metrics.anls — best-matching reference, 0.5
threshold floor), the template's metric (docvqa_val.yaml:3-6,
infovqa_val.yaml:3-7). The reference's test splits are submission-only
(answers withheld; docvqa_test_aggregate_results /
infovqa_test_aggregate_results just write the submission JSON,
docvqa/utils.py:20-31, infovqa/utils.py:25-31) — run these tasks with
--predict_only for that flow; the per-sample predictions in
samples.jsonl carry questionId + answer. The reference's qwen_vl prompt
variant (post_prompt " Answer:") is reachable via prompt_overrides.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import anls


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = ("\nAnswer the question using a single "
                                    "word or phrase.")) -> str:
    # _default_template_*_yaml lmms_eval_specific_kwargs.default
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def _make_process_results(prefix: str):
    def process_results(doc, response: str) -> dict:
        answers = doc.get("answers") or []
        if isinstance(answers, str):
            answers = [answers]
        return {
            "questionId": doc["questionId"],
            "pred": response,
            "anls": anls(answers, response),
        }
    return process_results


def _make_aggregate(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{prefix}_anls": 0.0}
        return {f"{prefix}_anls":
                sum(r["anls"] for r in records) / len(records)}
    return aggregate


def _make_load_docs(subset: str):
    def load_docs(data_root: str, split: str = "validation") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/DocVQA", data_root, split,
                                   subset=subset)
    return load_docs


for _name, _subset in (("docvqa", "DocVQA"), ("infovqa", "InfographicVQA")):
    register_task(Task(
        name=f"{_name}_val",
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answers"),  # template doc_to_target
        process_results=_make_process_results(_name),
        aggregate=_make_aggregate(_name),
        load_docs=_make_load_docs(_subset),
        doc_id_key="questionId",
        generation_kwargs={"max_new_tokens": 32, "temperature": 0,
                           "do_sample": False},
    ))
