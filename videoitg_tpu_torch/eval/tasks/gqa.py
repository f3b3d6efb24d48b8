"""GQA testdev-balanced benchmark (parity: lmms_eval/tasks/gqa/utils.py,
gqa.yaml).

Image task: docs carry id / question / answer / imageId. The reference
stores questions and images in two hub subsets of lmms-lab/GQA
(testdev_balanced_instructions + testdev_balanced_images) and joins at
doc_to_visual time by imageId (utils.py:7-16). Locally we keep the
join trivial: a doc may carry an inline "image" path (pre-joined rows),
otherwise the visual resolves to data_root/images/<imageId>.jpg —
documented divergence from the in-memory PIL join, same pairing.

Scoring: mean exact_match with ignore_case + ignore_punctuation
(gqa.yaml:17-21 — the HF evaluate knobs; eval/metrics.exact_match).
Prompt: question + "\\nAnswer the question using a single word or
phrase." (gqa.yaml:28-31); qwen_vl variant via prompt_overrides.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import exact_match


def doc_to_visual(doc, data_root: str = ""):
    import os

    if doc.get("image"):
        p = (os.path.join(data_root, doc["image"]) if data_root
             else doc["image"])
    else:
        p = os.path.join(data_root, "images", f"{doc['imageId']}.jpg")
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = ("\nAnswer the question using a single "
                                    "word or phrase.")) -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    return {
        "id": doc.get("id", ""),
        "pred": response,
        "exact_match": exact_match(response, [doc["answer"]],
                                   ignore_case=True,
                                   ignore_punctuation=True),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"gqa_exact_match": 0.0}
    return {"gqa_exact_match":
            sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "testdev") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/GQA", data_root, split,
                               subset="testdev_balanced_instructions")


register_task(Task(
    name="gqa",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # gqa.yaml:11
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="id",
    prompt_overrides={"qwen-vl-chat": {"post_prompt": " Answer:"}},
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
