"""CUVA: Causation Understanding of Video Anomaly.

Parity: lmms_eval/tasks/cuva/ — docs carry video_name / task
(Description | Cause | Result) / answer; the prompt is a fixed
per-category instruction (utils.py:122-134). Metrics (utils.py:146-216):
per-sample pycocoevalcap BLEU-4 and ROUGE-L (reimplemented
dependency-free in eval/coco_caption.py — PTB tokenization, 4-gram
brevity-penalty BLEU, LCS ROUGE-L), averaged per category, then the
mean of the three category means. The reference's third metric (BLEURT,
utils.py:174-205) needs the lucadiliello/BLEURT-20 checkpoint; it is
reported only when VIDEOITG_BLEURT_DIR points at a local copy (a
transformers BertForSequenceClassification regression head; no egress
in this environment).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.coco_caption import bleu_scores, ptb_tokenize, rouge_l

QUESTIONS = {
    "Description": (
        "Watch the video and describe any anomaly events you see in the "
        "order they happen. Focus on what is different from normal, like "
        "who or what is involved and their actions."),
    "Cause": (
        "Explain why the anomaly in the video are happening. Use what you "
        "see in the video to make logical reasoning about the root reasons "
        "behind these anomalies.Please ensure that your response is "
        "logically rigorous and directly related to the abnormal events in "
        "the video and the potential reasons behind them."),
    "Result": (
        "Figure out what results and effect these anomalies have. Link the "
        "anomaly directly to their outcomes, like how they affect people "
        "or the environment. Your answer should be as clear and specific "
        "as possible, avoiding generalities and focusing directly on the "
        "video rather than summarizing the impact of a type of event on "
        "society."),
}

CATEGORIES = ("Description", "Cause", "Result")


def doc_to_visual(doc, data_root: str = ""):
    """videos/<video_name> with the mp4 -> MP4 fallback (utils.py:108-118)."""
    base = os.path.join(data_root, "videos") if data_root else "videos"
    name = str(doc["video_name"])
    for cand in (name, name.replace("mp4", "MP4")):
        path = os.path.join(base, cand)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(base, name))


def doc_to_text(doc):
    return QUESTIONS[doc["task"]]


def process_results(doc, response: str) -> dict:
    return {"pred": response if isinstance(response, str) else "",
            "answer": doc["answer"], "task": doc["task"],
            "video_name": doc.get("video_name")}


def _sample_bleu4(ref: str, hyp: str) -> float:
    return bleu_scores({0: [ptb_tokenize(ref)]},
                       {0: [ptb_tokenize(hyp)]})[3]


def _sample_rouge(ref: str, hyp: str) -> float:
    return rouge_l({0: [ptb_tokenize(ref)]}, {0: [ptb_tokenize(hyp)]})


def _mean_of_category_means(per_cat: Dict[str, list]) -> float:
    """utils.py:160-170: mean per category (empty -> 0), then the mean of
    the three category values."""
    means = {c: (float(np.mean(v)) if v else 0.0)
             for c, v in per_cat.items()}
    return sum(means.values()) / len(means)


def _bleurt_scores(records: List[dict], model_dir: str) -> Dict[str, list]:
    import torch
    from transformers import AutoModelForSequenceClassification, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir)
    model = AutoModelForSequenceClassification.from_pretrained(model_dir)
    model.eval()
    per_cat: Dict[str, list] = {c: [] for c in CATEGORIES}
    for r in records:
        with torch.no_grad():
            inputs = tok([r["answer"]], [r["pred"]], padding="longest",
                         truncation=True, return_tensors="pt")
            res = model(**inputs).logits.flatten().tolist()
        per_cat[r["task"]].append(res[0])
    return per_cat


def aggregate(records: List[dict]) -> Dict[str, float]:
    per_bleu: Dict[str, list] = {c: [] for c in CATEGORIES}
    per_rouge: Dict[str, list] = {c: [] for c in CATEGORIES}
    for r in records:
        per_bleu[r["task"]].append(_sample_bleu4(r["answer"], r["pred"]))
        per_rouge[r["task"]].append(_sample_rouge(r["answer"], r["pred"]))
    out = {"cuva_BLEU": _mean_of_category_means(per_bleu),
           "cuva_ROUGE": _mean_of_category_means(per_rouge)}
    bleurt_dir = os.environ.get("VIDEOITG_BLEURT_DIR")
    if bleurt_dir and records:
        out["cuva_BLEURT"] = _mean_of_category_means(
            _bleurt_scores(records, bleurt_dir))
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("fesvhtr/CUVA_LMMs", data_root, split)


register_task(Task(
    name="cuva_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="cuva_BLEU",
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                       "do_sample": False},
))

register_group("cuva", ["cuva_test"])
