"""ScienceQA-IMG (parity: lmms_eval/tasks/scienceqa/utils.py,
scienceqa_img.yaml).

Image task: docs carry question / hint (optional context) / choices
(texts) / answer (int index) / image (path relative to data_root; the
reference's ScienceQA-IMG split always has one — its full-split rows
without an image return [] from doc_to_visual, which this single-visual
harness doesn't model, so only the IMG split is ported).

Prompt parity (utils.py:1-19): the default format renders
"Context: {hint}\\n" (when present) + question + lettered choices + the
letter instruction; the qwen_vl format is the fixed
"Context/Question/Options/Answer:" template with "N/A" for a missing
hint — selectable via prompt_overrides {"format": "qwen_vl"}.

Scoring parity (utils.py:33-44, "it's how llava parse it"): exact
lowered match of the response to the target letter, else a response
shaped like "B. ..." matches on its first char; everything else is 0.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def _choices_str(doc) -> str:
    letters = [chr(ord("A") + i) for i in range(len(doc["choices"]))]
    return "\n".join(f"{letter}. {choice}"
                     for letter, choice in zip(letters, doc["choices"]))


def doc_to_text(
    doc, format: str = "default", pre_prompt: str = "",
    post_prompt: str = ("\nAnswer with the option's letter from the given "
                        "choices directly."),
) -> str:
    context, question = doc.get("hint") or "", doc["question"]
    if format == "default":
        if context:
            context = f"Context: {context}\n"
        return f"{pre_prompt}{context}{question}\n{_choices_str(doc)}{post_prompt}"
    if format == "qwen_vl":
        return ("Context: {}\nQuestion: {}\nOptions: {}\nAnswer:".format(
            context if context else "N/A", question, _choices_str(doc)))
    raise ValueError(f"unknown prompt format: {format!r}")


def doc_to_target(doc) -> str:
    return chr(ord("A") + int(doc["answer"]))  # utils.py:28-31


def process_results(doc, response: str) -> dict:
    target = doc_to_target(doc).strip().lower()
    pred = response.strip().lower()
    if pred == target:
        score = 1.0
    elif len(pred) >= 2 and pred[0].isupper() and pred[1] == ".":
        # NOTE: replicated byte-for-byte from utils.py:41-43 — pred was
        # just lowered, so isupper() can never be true for a letter and
        # this "B. text" branch is dead upstream too; such responses
        # score 0 exactly as they do in the reference (scores must be
        # reference-comparable, bugs included).
        score = 1.0 if pred[0] == target else 0.0
    else:
        score = 0.0
    return {"pred": pred, "target": target, "exact_match": score}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"scienceqa_exact_match": 0.0}
    return {"scienceqa_exact_match":
            100.0 * sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/ScienceQA", data_root, split,
                               subset="ScienceQA-IMG")


register_task(Task(
    name="scienceqa_img",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=doc_to_target,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
