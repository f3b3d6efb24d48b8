"""Q-Bench / Q-Bench2 / A-Bench (parity: lmms_eval/tasks/qbench/
utils.py + qbench_dev.yaml / qbench2_dev.yaml / abench_dev.yaml; group
qbenchs_dev.yaml).

Low-level visual-quality MCQ: ``qbench_dev`` (q-future/Q-Bench-HF),
``qbench2_dev`` (q-future/Q-Bench2-HF, image PAIRS), ``abench_dev``
(q-future/A-Bench-HF, AI-generated imagery), all dev split. Docs carry
question / option0..option3 ("N/A" padding) / correct_choice /
id / image (or image1+image2 for qbench2) plus question_concern +
question_type ints (qbench) or category (abench).

Parity:
* doc_to_text (utils.py:8-18): question + "A. x" lines over the
  non-"N/A" options + post_prompt "Answer with the option's letter
  from the given choices directly.\\n".
* visuals (utils.py:21-25): [image] or [image1, image2].
* answer parsing: the option list is truncated at the first "N/A"
  (utils.py:157-163) and run through the official MMMU
  parse_multi_choice_response — reused from tasks/mmmu.py. (The
  vendored copy in qbench/utils.py:44-103 references `random` and
  `np` WITHOUT importing them, so its no-candidate and multi-candidate
  paths would NameError upstream; the shared implementation with the
  deterministic crc32 fallback is used instead.)
* aggregation (utils.py:171-200): rollups over question_concern
  (Global/Local Distortion/Others) and question_type (Yes/No, How,
  What) for qbench, category for abench; overall = instruction-level
  acc over the union of rollup buckets (each sample counted once per
  bucket it appears in — qbench samples appear in exactly two, so this
  equals plain accuracy; preserved as-is).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.mmmu import parse_multi_choice_response

POST_PROMPT = "Answer with the option's letter from the given choices directly.\n"

CONCERN_LIST = ("Global Distortion", "Global Others", "Local Distortion",
                "Local Others")
QUESTION_LIST = ("Yes/No", "How", "What")


def _options(doc) -> List[str]:
    """utils.py:157-163 — truncate at the first 'N/A'."""
    out = []
    for i in range(4):
        o = doc.get(f"option{i}")
        if o == "N/A" or o is None:
            break
        out.append(o)
    return out


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    # utils.py:8-18 — the prompt builder SKIPS "N/A" anywhere (the
    # scorer truncates at the first); both preserved
    candidates = [doc.get(f"option{i}") for i in range(4)]
    candidates = [c for c in candidates if c != "N/A" and c is not None]
    block = "\n".join(f"{chr(ord('A') + i)}. {c}"
                      for i, c in enumerate(candidates))
    return f"{pre_prompt}{doc['question']}\n{block}\n{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    def resolve(v):
        if hasattr(v, "convert"):
            return v
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        return p

    if "image2" in doc and doc["image2"] is not None:
        return [resolve(doc["image1"]), resolve(doc["image2"])]
    return resolve(doc["image"])


def _parse(doc, response: str) -> str:
    options = _options(doc)
    letters = [chr(ord("A") + i) for i in range(len(options))]
    return parse_multi_choice_response(response, letters,
                                       dict(zip(letters, options)),
                                       doc_id=str(doc["id"]))


def process_results(doc, response: str) -> dict:
    return {"id": doc["id"],
            "question_concern": doc.get("question_concern"),
            "question_type": doc.get("question_type"),
            "category": doc.get("category"),
            "answer": doc["correct_choice"],
            "parsed_pred": _parse(doc, response),
            "prediction": response}


def _ins_level(buckets: Dict[str, list]) -> float:
    n = sum(len(v) for v in buckets.values())
    if n == 0:
        return 0.0
    return sum(sum(v) for v in buckets.values()) / n


def _slug(s) -> str:
    return re.sub(r"\W+", "_", str(s).lower()).strip("_")


def aggregate_qbench(records: List[dict]) -> Dict[str, float]:
    buckets: Dict[str, list] = defaultdict(list)
    for r in records:
        hit = float(r["answer"] == r["parsed_pred"])
        buckets[CONCERN_LIST[r["question_concern"]]].append(hit)
        buckets[QUESTION_LIST[r["question_type"]]].append(hit)
    out = {"qbench_acc": round(_ins_level(buckets), 5)}
    for b, v in sorted(buckets.items()):
        out[f"qbench_{_slug(b)}"] = round(sum(v) / len(v), 5)
    return out


def aggregate_abench(records: List[dict]) -> Dict[str, float]:
    buckets: Dict[str, list] = defaultdict(list)
    for r in records:
        buckets[r["category"]].append(float(r["answer"] == r["parsed_pred"]))
    out = {"abench_acc": round(_ins_level(buckets), 5)}
    for b, v in sorted(buckets.items()):
        out[f"abench_{_slug(b)}"] = round(sum(v) / len(v), 5)
    return out


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "dev") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 32, "temperature": 0, "do_sample": False}

for _name, _hub, _agg, _primary in (
        ("qbench_dev", "q-future/Q-Bench-HF", aggregate_qbench,
         "qbench_acc"),
        ("qbench2_dev", "q-future/Q-Bench2-HF", aggregate_qbench,
         "qbench_acc"),
        ("abench_dev", "q-future/A-Bench-HF", aggregate_abench,
         "abench_acc")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc["correct_choice"],
        process_results=process_results,
        aggregate=_agg,
        primary_metric=_primary,
        load_docs=_make_load(_hub),
        generation_kwargs=dict(_GEN),
    ))
