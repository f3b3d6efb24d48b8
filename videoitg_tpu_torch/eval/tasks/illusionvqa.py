"""IllusionVQA (parity: lmms_eval/tasks/illusionvqa/utils.py +
illusionvqa.yaml + the comprehension / soft_localization yamls).

Optical-illusion MCQ: ``illusionvqa_comprehension``
(csebuetnlp/illusionVQA-Comprehension) and
``illusionvqa_soft_localization`` (csebuetnlp/illusionVQA-Soft-
Localization), both test split. Docs carry question / options (list) /
answer (the option TEXT) / image.

Parity:
* doc_to_text (utils.py:8-17): pre_prompt (the fixed letter-only
  instruction, illusionvqa.yaml:19) + question + "A. x" option lines.
* doc_to_target (utils.py:20-23): the gold LETTER derived from
  options.index(answer).
* filter "flexible-extract": leading "<LETTER>." wins, else
  passthrough (utils.py:26-64 — the same degenerate
  MultiChoiceRegexFilter as muirbench; shared as the registered
  ``muir_letter`` filter).
* metric: exact_match of filtered response vs gold letter with
  ignore_case + ignore_punctuation, aggregation mean.
"""

from __future__ import annotations

import string
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.muirbench import MuirLetterFilter  # noqa: F401

PRE_PROMPT = ("You'll be given an image, an instruction and some options. "
              "You have to select the correct one. Do not explain your "
              "reasoning. Answer with only the letter which corresponds to "
              "the correct option. Do not repeat the entire answer.")


def doc_to_text(doc, pre_prompt: str = PRE_PROMPT,
                post_prompt: str = "") -> str:
    letters = [chr(ord("A") + i) for i in range(len(doc["options"]))]
    block = "\n".join(f"{l}. {o}" for l, o in zip(letters, doc["options"]))
    return f"{pre_prompt}{doc['question']}\n{block}{post_prompt}"


def doc_to_target(doc) -> str:
    letters = [chr(ord("A") + i) for i in range(len(doc["options"]))]
    return letters[doc["options"].index(doc["answer"])]


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def _norm(s: str) -> str:
    s = s.lower().strip()
    return "".join(c for c in s if c not in string.punctuation).strip()


def process_results(doc, response: str) -> dict:
    return {"target": doc_to_target(doc), "pred": response,
            "exact_match": float(_norm(response) == _norm(doc_to_target(doc)))}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"illusionvqa_exact_match": 0.0}
    return {"illusionvqa_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


for _name, _hub in (
        ("illusionvqa_comprehension", "csebuetnlp/illusionVQA-Comprehension"),
        ("illusionvqa_soft_localization",
         "csebuetnlp/illusionVQA-Soft-Localization")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=doc_to_target,
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="illusionvqa_exact_match",
        load_docs=_make_load(_hub),
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
        filters=[("muir_letter", None)],
    ))
