"""ChartQA image benchmark (parity: lmms_eval/tasks/chartqa/utils.py,
chartqa.yaml).

Image task: docs carry question / answer / type ("human_test" or
augmented) / image (path relative to data_root).

Scoring parity — relaxed correctness (utils.py:25-64, the Qwen-VL
implementation the reference vendors): numeric answers (with % support)
match within 5% relative error; non-numeric answers need an exact
lowercase match. NOTE the replicated operand order quirk: a gold answer
of "0" makes target_float falsy, so "0" vs "0" falls through to the
string branch (still correct) — kept bug-for-bug. Rollups: overall +
human/augmented splits (utils.py:12-22).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_task


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = ("\nAnswer the question using a single "
                                    "word or phrase.")) -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def _to_float(text: str) -> Optional[float]:
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_correctness(prediction: str, target: str,
                        max_relative_change: float = 0.05) -> bool:
    """utils.py:25-64 (arXiv:2203.10244 §5.1 relaxed accuracy)."""
    prediction_float = _to_float(prediction)
    target_float = _to_float(target)
    if prediction_float is not None and target_float:
        relative_change = (abs(prediction_float - target_float)
                           / abs(target_float))
        return relative_change <= max_relative_change
    return prediction.lower() == target.lower()


def process_results(doc, response: str) -> dict:
    return {
        "type": doc.get("type", ""),
        "pred": response,
        "answer": doc["answer"],
        "score": 1.0 if relaxed_correctness(response, doc["answer"]) else 0.0,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"chartqa_relaxed_overall": 0.0}
    out = {"chartqa_relaxed_overall":
           sum(r["score"] for r in records) / len(records)}
    for key, name in (("human_test", "relaxed_human_split"),
                      ("augmented_test", "relaxed_augmented_split")):
        sub = ([r for r in records if r["type"] == "human_test"]
               if key == "human_test"
               else [r for r in records if r["type"] != "human_test"])
        if sub:
            out[f"chartqa_{name}"] = sum(r["score"] for r in sub) / len(sub)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/ChartQA", data_root, split)


register_task(Task(
    name="chartqa",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answer"],  # chartqa.yaml:9
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
