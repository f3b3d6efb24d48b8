"""MuirBench (parity: lmms_eval/tasks/muirbench/utils.py +
muirbench.yaml).

Multi-image understanding MCQ over MUIRBENCH/MUIRBENCH test. Docs
carry question / options / answer (a letter) / image_list /
task / idx / image_relation / image_type.

Parity:
* doc_to_text (utils.py:9-16): question + "A. x" option lines +
  post_prompt "\\nAnswer with the option's letter from the given
  choices directly.".
* visuals: the full image_list in order (utils.py:19-21) — rides the
  adapter's multi-image PIL/path list branch.
* filter "flexible-extract" (utils.py:74-114 MultiChoiceRegexFilter.
  apply): if the response STARTS with "<letter>." the letter is kept,
  otherwise the response passes through unchanged. (The reference
  subclasses ExtendedRegexFilter but its apply() never consults the
  base machinery — only the ^([A-Z])\\. probe runs. Ported exactly.)
* scoring (utils.py:47-71): case-insensitive stripped equality of the
  filtered prediction vs the gold letter; overall mean is the headline
  plus per-task means (muirbench_score_<task>).
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.filters import FILTER_REGISTRY, Filter

POST_PROMPT = "\nAnswer with the option's letter from the given choices directly."

_OPTION_LETTER_RE = re.compile(r"^\s*([A-Z])\.")


class MuirLetterFilter(Filter):
    """utils.py:74-114 — leading '<LETTER>.' wins, else passthrough."""

    def apply(self, resps, docs):
        out = []
        for r, _doc in zip(resps, docs):
            filtered = []
            for resp in r:
                m = _OPTION_LETTER_RE.match(resp)
                filtered.append(m.group(1) if m else resp)
            out.append(filtered)
        return out


FILTER_REGISTRY.setdefault("muir_letter", MuirLetterFilter)


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    options = [chr(ord("A") + i) for i in range(len(doc["options"]))]
    block = "\n".join(f"{o}. {c}" for o, c in zip(options, doc["options"]))
    return f"{pre_prompt}{doc['question']}\n{block}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    out = []
    for img in doc["image_list"]:
        if hasattr(img, "convert"):
            out.append(img)
            continue
        p = os.path.join(data_root, img) if data_root else img
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def process_results(doc, response: str) -> dict:
    return {"pred": response, "task": doc["task"], "idx": doc["idx"],
            "image_relation": doc.get("image_relation"),
            "answer": doc["answer"], "image_type": doc.get("image_type")}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"muirbench_score_overall": 0.0}
    by_task: Dict[str, list] = {}
    for r in records:
        hit = r["pred"].lower().strip() == r["answer"].lower().strip()
        by_task.setdefault(r["task"], []).append(float(hit))
    out = {"muirbench_score_overall":
           sum(sum(v) for v in by_task.values()) / len(records)}
    for task, v in sorted(by_task.items()):
        slug = re.sub(r"\W+", "_", task.lower()).strip("_")
        out[f"muirbench_score_{slug}"] = sum(v) / len(v)
    return out


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("MUIRBENCH/MUIRBENCH", data_root, split)


register_task(Task(
    name="muirbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="muirbench_score_overall",
    load_docs=_load,
    doc_id_key="idx",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
    filters=[("muir_letter", None)],
))
