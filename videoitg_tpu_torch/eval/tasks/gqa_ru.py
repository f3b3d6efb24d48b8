"""GQA-ru (parity: lmms_eval/tasks/gqa_ru/utils.py + gqa_ru.yaml).

Russian GQA over deepvk/GQA-ru (config
testdev_balanced_instructions, split testdev). Same two-subset
imageId join as English GQA (utils.py:7-16 lazily loads
testdev_balanced_images): locally a doc may carry an inline "image"
path, otherwise data_root/images/<imageId>.jpg — the same documented
divergence as tasks/gqa.py.

Prompt: question + "\\nОтветь одним словом." (gqa_ru.yaml:27-30).
Scoring: mean exact_match with ignore_case + ignore_punctuation.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import exact_match
from videoitg_tpu_torch.eval.tasks.gqa import doc_to_visual  # same join rule

POST_PROMPT = "\nОтветь одним словом."


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    return {"id": doc.get("id", ""), "pred": response,
            "exact_match": exact_match(response, [doc["answer"]],
                                       ignore_case=True,
                                       ignore_punctuation=True)}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"gqa_ru_exact_match": 0.0}
    return {"gqa_ru_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def _load(data_root: str, split: str = "testdev") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("deepvk/GQA-ru", data_root, split,
                               subset="testdev_balanced_instructions")


register_task(Task(
    name="gqa_ru",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="gqa_ru_exact_match",
    load_docs=_load,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
