"""POPE object-hallucination benchmark (parity: lmms_eval/tasks/pope/
utils.py, pope.yaml + the adv/pop/random split variants).

Image task: docs carry question_id / image (path relative to data_root;
the reference's HF split embeds PIL, utils.py:5-6) / question / answer
("yes"/"no") / category (the sampling strategy: adversarial / popular /
random — pope_full aggregates all three, the split tasks filter one).

Scoring parity (utils.py:18-96): prediction = response lower().strip(),
exact compare against gold for accuracy; precision/recall/F1 computed
over the yes-class confusion counts; yes_ratio is the GOLD yes fraction
(utils.py:88-96 counts ground-truth labels, not predictions).
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


def doc_to_text(doc) -> str:
    # utils.py:9-12
    question = doc["question"].strip()
    return f"{question}\nAnswer the question using a single word or phrase."


def process_results(doc, response: str) -> dict:
    pred = response.lower().strip()
    gt = doc["answer"].lower().strip()
    assert gt in ("yes", "no"), f"bad POPE gold answer {doc['answer']!r}"
    return {
        "question_id": doc["question_id"],
        "category": doc.get("category", ""),
        "prediction": pred,
        "ground_truth": gt,
        "score": 1.0 if pred == gt else 0.0,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"pope_accuracy": 0.0}
    tp = sum(r["ground_truth"] == "yes" and r["prediction"] == "yes"
             for r in records)
    fp = sum(r["ground_truth"] == "no" and r["prediction"] == "yes"
             for r in records)
    fn = sum(r["ground_truth"] == "yes" and r["prediction"] == "no"
             for r in records)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    n_yes = sum(r["ground_truth"] == "yes" for r in records)
    return {
        "pope_accuracy": sum(r["score"] for r in records) / len(records),
        "pope_precision": precision,
        "pope_recall": recall,
        "pope_f1_score": f1,
        "pope_yes_ratio": n_yes / len(records),
    }


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/POPE", data_root, split)


def _make(name: str, category: str = "") -> Task:
    def _load(data_root: str, split: str = "test",
              _cat=category) -> List[dict]:
        docs = load_docs(data_root, split)
        return ([d for d in docs if d.get("category") == _cat] if _cat
                else docs)

    return Task(
        name=name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc["answer"],  # pope.yaml:9
        process_results=process_results,
        aggregate=aggregate,
        load_docs=_load,
        # pope.yaml:10-15
        generation_kwargs={"max_new_tokens": 128, "temperature": 0,
                           "top_p": 1.0, "num_beams": 1, "do_sample": False},
    )


register_task(_make("pope"))  # full set, all strategies
register_task(_make("pope_adv", "adversarial"))
register_task(_make("pope_pop", "popular"))
register_task(_make("pope_random", "random"))
