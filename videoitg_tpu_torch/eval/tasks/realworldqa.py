"""RealWorldQA image benchmark (parity: lmms_eval/tasks/realworldqa/
utils.py, realworldqa.yaml).

Image task: docs carry question (with the "A. text" choice lines
embedded) / answer (a letter for MC questions, a word/number otherwise)
/ image path relative to data_root.

Filter-pipeline parity (the yaml's flexible-extract ensemble,
realworldqa.yaml:17-25): (1) spelled-out number words map to digits
(utils.py NumberWordsToDigitsFilter — identity on non-matches);
(2) the task's custom MultiChoiceRegexFilter override (utils.py:71-116):
parse the question's choices with \\b([A-Z])\\.\\s+([^\\n]*), strip all
punctuation from the response, and if a choice text occurs in it emit
that choice's letter, else keep the cleaned response. Scoring
(utils.py:36-45): exact match of the filtered response, lowercased/
stripped/rstrip('.'), against the gold answer lowercased.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.filters import FILTER_REGISTRY, Filter

# Stripped from the question when a post_prompt override is configured
# (utils.py:5,21-24); the default kwargs are empty so the question passes
# through verbatim (realworldqa.yaml:38-41).
REPLACE_PROMPT = ("Please answer directly with only the letter of the "
                  "correct option and nothing else.")

_NUMBER_WORDS = {"zero": "0", "one": "1", "two": "2", "three": "3",
                 "four": "4", "five": "5", "six": "6", "seven": "7",
                 "eight": "8", "nine": "9", "ten": "10"}


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    # utils.py:13-26
    question = doc["question"].strip()
    if post_prompt:
        question = question.replace(REPLACE_PROMPT, "")
    return f"{pre_prompt}{question}{post_prompt}"


class RealWorldQAExtractFilter(Filter):
    """Both yaml filter steps fused, in order (see module docstring)."""

    _choices_re = re.compile(r"\b([A-Z])\.\s+([^\n]*)")

    def apply(self, resps, docs):
        out = []
        for r, doc in zip(resps, docs):
            choice_to_alpha = {
                text.strip(): letter
                for letter, text in self._choices_re.findall(
                    (doc or {}).get("question", ""))
                if text.strip()
            }
            # utils.py:102: "|".join over the escaped choice texts — an
            # empty choice set yields the empty pattern, which matches ""
            # and falls through to the cleaned response, as upstream.
            pattern = re.compile("|".join(
                re.escape(t) for t in choice_to_alpha))
            filtered = []
            for resp in r:
                resp = _NUMBER_WORDS.get(resp.lower(), resp)
                cleaned = re.sub(r"[^\w\s]", "", resp).strip()
                m = pattern.search(cleaned)
                if m and m.group() in choice_to_alpha:
                    filtered.append(choice_to_alpha[m.group()])
                else:
                    filtered.append(cleaned)
            out.append(filtered)
        return out


FILTER_REGISTRY["realworldqa_extract"] = RealWorldQAExtractFilter


def process_results(doc, response: str) -> dict:
    # utils.py:36-45 (response arrives already filtered)
    pred = response.lower().strip().rstrip(".")
    gt = doc["answer"].lower().strip()
    return {"pred": pred, "answer": gt,
            "exact_match": 1.0 if pred == gt else 0.0}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"realworldqa_exact_match": 0.0}
    return {"realworldqa_exact_match":
            100.0 * sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/RealWorldQA", data_root, split)


register_task(Task(
    name="realworldqa",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # realworldqa.yaml:9
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    filters=[("realworldqa_extract", None)],  # the flexible-extract chain
    # realworldqa.yaml:11-16
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "top_p": 1.0, "num_beams": 1, "do_sample": False},
))
