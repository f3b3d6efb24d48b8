"""OCRBench (parity: lmms_eval/tasks/ocrbench/utils.py, ocrbench.yaml).

Image task: docs carry question / answer (string or list of acceptable
strings) / dataset (source benchmark name, e.g. "HME100k") / question_type
(one of the ten categories below) / image (path relative to data_root;
the reference HF split embeds PIL, utils.py:20-22).

Scoring parity (utils.py:31-60): containment — a sample scores 1 if any
gold answer appears as a substring of the prediction, after
normalization. Prediction is lower().strip() once up front. For
dataset == "HME100k" (handwritten math) both sides additionally drop ALL
whitespace, and — kept bug-for-bug — the gold is NOT lowercased in that
branch (the prediction already was, so an uppercase HME gold can never
match). All other datasets lowercase/strip both sides and collapse
newlines to spaces.

Aggregation (utils.py:63-93): per-category point sums; Text Recognition
is the sum of the six recognition categories (total 300); the final
score sums recognition + Scene Text-centric VQA + Doc-oriented VQA +
Key Information Extraction + HMER (total 1000); the headline accuracy is
final/1000. The reference accumulates into a module-global dict (a
cross-run leak, utils.py:6-17,64-65) — we fold per-call. The per-category
breakdown the reference prints to a results txt is returned as metrics.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

# utils.py:6-17 — the ten categories; order matters only for reporting.
RECOGNITION_TYPES = (
    "Regular Text Recognition",
    "Irregular Text Recognition",
    "Artistic Text Recognition",
    "Handwriting Recognition",
    "Digit String Recognition",
    "Non-Semantic Text Recognition",
)
OTHER_TYPES = (
    "Scene Text-centric VQA",
    "Doc-oriented VQA",
    "Key Information Extraction",
    "Handwritten Mathematical Expression Recognition",
)
ALL_TYPES = RECOGNITION_TYPES + OTHER_TYPES


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc) -> str:
    # utils.py:25-28 — bare question, no pre/post prompt.
    return doc["question"].strip()


def score_response(pred: str, gt_ans, dataset_name: str) -> int:
    """utils.py:31-60 containment rule (see module docstring quirks)."""
    pred = pred.lower().strip()
    golds = gt_ans if isinstance(gt_ans, list) else [gt_ans]
    if dataset_name == "HME100k":
        predict = pred.strip().replace("\n", " ").replace(" ", "")
        for g in golds:
            answer = g.strip().replace("\n", " ").replace(" ", "")
            if answer in predict:
                return 1
    else:
        predict = pred.lower().strip().replace("\n", " ")
        for g in golds:
            answer = g.lower().strip().replace("\n", " ")
            if answer in predict:
                return 1
    return 0


def process_results(doc, response: str) -> dict:
    return {
        "question_type": doc["question_type"],
        "prediction": response.lower().strip(),
        "score": score_response(response, doc["answer"], doc["dataset"]),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    per_type = {t: 0 for t in ALL_TYPES}
    for r in records:
        per_type[r["question_type"]] += r["score"]
    recognition = sum(per_type[t] for t in RECOGNITION_TYPES)
    final = recognition + sum(per_type[t] for t in OTHER_TYPES)
    out = {"ocrbench_accuracy": final / 1000.0,  # utils.py:93
           "ocrbench_final_score": float(final),
           "ocrbench_text_recognition": float(recognition)}
    for t in OTHER_TYPES:
        key = ("ocrbench_hmer" if t.startswith("Handwritten")
               else "ocrbench_" + t.lower().replace(" ", "_").replace("-", "_"))
        out[key] = float(per_type[t])
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("echo840/OCRBench", data_root, split)


register_task(Task(
    name="ocrbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # ocrbench.yaml:12
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="ocrbench_accuracy",
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 128, "temperature": 0,
                       "do_sample": False},
))
