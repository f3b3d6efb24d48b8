"""SEED-Bench-2 and SEED-Bench-2-Plus (parity: lmms_eval/tasks/
seedbench_2/utils.py + seedbench_2.yaml; seedbench_2_plus/utils.py +
seedbench_2_plus.yaml).

* ``seedbench_2`` (lmms-lab/SEED-Bench-2 test): docs carry question /
  choice_a..d / answer (letter) / data_type / data_id / question_id /
  image (a LIST). Image-path choices render as the model's image token
  (parse_choice_img, utils.py:8-11; default "<image>" — per-model via
  prompt_overrides); "Image Generation" docs prepend
  len(data_id)-4 image tokens (utils.py:22-25). Scoring: first
  character of the stripped response vs the gold letter, CASE-
  SENSITIVE (utils.py:29-47 — the v2 scorer does NOT lowercase,
  unlike 2-Plus; preserved), rolled up per data_type
  (seed_<data_type>) and overall (seed_all).
* ``seedbench_2_plus`` (doolayer/SEED-Bench-2-Plus test): single image,
  choice_A..D fields, question_image_type rollups
  (seedbench_2_plus_<Type>), and case-INSENSITIVE comparison
  (utils.py:36-44).

The reference's question.replace("<img>", ...) result is DISCARDED
(str.replace returns, utils.py:15 on both) — a no-op preserved by not
replacing at all.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

POST_PROMPT = "Answer with the option's letter from the given choices directly."


def parse_choice_img(choice: str, img_token: str) -> str:
    if "jpg" in choice or "png" in choice:
        return img_token
    return choice


def _resolve_list(images, data_root: str):
    import os

    out = []
    for v in images:
        if hasattr(v, "convert"):
            out.append(v)
            continue
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


# --- SEED-Bench-2 ----------------------------------------------------------

def doc_to_text_v2(doc, img_token: str = "<image>",
                   post_prompt: str = POST_PROMPT) -> str:
    q = doc["question"]
    q += "\n" + f"A. {parse_choice_img(doc['choice_a'], img_token)}\n"
    q += f"B. {parse_choice_img(doc['choice_b'], img_token)}\n"
    q += f"C. {parse_choice_img(doc['choice_c'], img_token)}\n"
    q += f"D. {parse_choice_img(doc['choice_d'], img_token)}"
    if doc["data_type"] == "Image Generation":
        n = len(doc["data_id"]) - 4
        q = " ".join([img_token] * n) + "\n" + q
    return f"{q}\n{post_prompt}"


def doc_to_visual_v2(doc, data_root: str = ""):
    return _resolve_list(doc["image"], data_root)


def process_results_v2(doc, response: str) -> dict:
    pred = response.strip()
    if len(pred) > 1:
        pred = pred[0]
    return {"pred": pred, "answer": doc["answer"],
            "question_id": doc["question_id"],
            "data_type": doc["data_type"]}


def aggregate_v2(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"seed_all": 0.0}
    out = {"seed_all":
           sum(r["pred"] == r["answer"] for r in records) / len(records)}
    by_type: Dict[str, list] = {}
    for r in records:
        key = "_".join(r["data_type"].split(" "))
        by_type.setdefault(key, []).append(
            float(r["pred"] == r["answer"]))
    for k, v in sorted(by_type.items()):
        out[f"seed_{k}"] = sum(v) / len(v)
    return out


# --- SEED-Bench-2-Plus -----------------------------------------------------

def doc_to_text_plus(doc, img_token: str = "<image>",
                     post_prompt: str = POST_PROMPT) -> str:
    q = doc["question"]
    q += "\n" + f"A. {parse_choice_img(doc['choice_A'], img_token)}\n"
    q += f"B. {parse_choice_img(doc['choice_B'], img_token)}\n"
    q += f"C. {parse_choice_img(doc['choice_C'], img_token)}\n"
    q += f"D. {parse_choice_img(doc['choice_D'], img_token)}"
    return f"{q}\n{post_prompt}"


def doc_to_visual_plus(doc, data_root: str = ""):
    return _resolve_list([doc["image"]], data_root)[0]


def process_results_plus(doc, response: str) -> dict:
    pred = response.strip()
    if len(pred) > 1:
        pred = pred[0]
    return {"pred": pred, "answer": doc["answer"],
            "question_id": doc["question_id"],
            "question_image_type": doc["question_image_type"]}


def aggregate_plus(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"seedbench_2_plus_all": 0.0}

    def hit(r):
        return r["pred"].lower().strip() == r["answer"].lower().strip()

    out = {"seedbench_2_plus_all":
           sum(hit(r) for r in records) / len(records)}
    by_type: Dict[str, list] = {}
    for r in records:
        key = r["question_image_type"].capitalize()
        by_type.setdefault(key, []).append(float(hit(r)))
    for k, v in sorted(by_type.items()):
        out[f"seedbench_2_plus_{k}"] = sum(v) / len(v)
    return out


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 16, "temperature": 0, "do_sample": False}

register_task(Task(
    name="seedbench_2",
    doc_to_visual=doc_to_visual_v2,
    doc_to_text=doc_to_text_v2,
    doc_to_target=lambda doc: doc["answer"],
    process_results=process_results_v2,
    aggregate=aggregate_v2,
    primary_metric="seed_all",
    load_docs=_make_load("lmms-lab/SEED-Bench-2"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="seedbench_2_plus",
    doc_to_visual=doc_to_visual_plus,
    doc_to_text=doc_to_text_plus,
    doc_to_target=lambda doc: doc["answer"],
    process_results=process_results_plus,
    aggregate=aggregate_plus,
    primary_metric="seedbench_2_plus_all",
    load_docs=_make_load("doolayer/SEED-Bench-2-Plus"),
    doc_id_key="question_id",
    generation_kwargs=dict(_GEN),
))
