"""AI2D diagram-QA image benchmark (parity: lmms_eval/tasks/ai2d/
utils.py, ai2d.yaml).

Image task (stills through the downstream adapters): docs carry question
/ options (choice texts) / answer (int index as a string) / image (path
relative to data_root; the reference's HF split embeds PIL).

Prompt parity (utils.py:7-25): the default "mcq" format renders lettered
choice lines + the letter instruction (ai2d.yaml:12-15); "qa" renders
bare choice texts with " Answer:" (the reference's qwen_vl profile) —
selectable per model via prompt_overrides {"prompt_format": "qa", ...}.
The target follows the format: the answer letter for mcq, the choice
text for qa (utils.py:31-37).

Filter parity (utils.py:60-79 — the task's custom MultiChoiceRegexFilter
override): a response starting with "X." yields the letter, anything
else passes through unchanged. Scoring: exact_match with
ignore_case+ignore_punctuation (ai2d.yaml:47-52).
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.filters import FILTER_REGISTRY, Filter


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(
    doc, prompt_format: str = "mcq", pre_prompt: str = "",
    post_prompt: str = ("\nAnswer with the option's letter from the given "
                        "choices directly."),
) -> str:
    question, choices = doc["question"], doc["options"]
    if prompt_format == "mcq":
        letters = [chr(ord("A") + i) for i in range(len(choices))]
        choices_str = "\n".join(
            f"{letter}. {choice}" for letter, choice in zip(letters, choices))
        return f"{pre_prompt}{question}\n{choices_str}{post_prompt}"
    if prompt_format == "qa":
        return f"{pre_prompt}{question}" + "\n".join(choices) + post_prompt
    raise ValueError(f"unknown prompt format: {prompt_format!r}")


def doc_to_target(doc, target_format: str = "mcq") -> str:
    # utils.py:31-37
    if target_format == "qa":
        return doc["options"][int(doc["answer"])]
    return chr(ord("A") + int(doc["answer"]))


class AI2DLetterFilter(Filter):
    """utils.py:60-79: leading "X." -> the letter, else pass-through."""

    _leading = re.compile(r"^\s*([A-Z])\.")

    def apply(self, resps, docs):
        out = []
        for r in resps:
            filtered = []
            for resp in r:
                m = self._leading.match(resp)
                filtered.append(m.group(1) if m else resp)
            out.append(filtered)
        return out


FILTER_REGISTRY["ai2d_letter"] = AI2DLetterFilter


def _norm(s: str) -> str:
    # the metric's ignore_case + ignore_punctuation (ai2d.yaml:49-52)
    return re.sub(r"[^\w\s]", "", s.lower()).strip()


def process_results(doc, response: str) -> dict:
    target = doc_to_target(doc)
    return {"pred": response, "target": target,
            "exact_match": 1.0 if _norm(response) == _norm(target) else 0.0}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"ai2d_exact_match": 0.0}
    return {"ai2d_exact_match":
            100.0 * sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/ai2d", data_root, split)


register_task(Task(
    name="ai2d",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=doc_to_target,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    filters=[("ai2d_letter", None)],  # the yaml's flexible-extract
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
