"""YouCook2 segment-captioning task (youcook2_val).

Parity: lmms_eval/tasks/youcook2/ — docs carry video_path / youtube_id /
segment / sentence (one reference caption per segment). Prompt is the
yaml default ("Provide a one-sentence caption for the provided video.");
non-ASCII chars are blanked from both sides before scoring
(utils.py:20-21). Aggregation reproduces the reference exactly
(utils.py:63-100): segments are grouped per youtube video, each video's
segment set is scored as its own coco corpus, and the per-video scores
are averaged then scaled x100. That includes the reference's Bleu quirk:
Bleu(4).compute_score returns the [b1..b4] list and the aggregator
np.mean's it, so every Bleu_n metric collapses to the same
mean-of-the-four-bleus value — reproduced as-is for score parity.
METEOR is omitted (Java jar dependency in the reference; unavailable
offline).
"""

from __future__ import annotations

import os
from collections import defaultdict
from statistics import mean
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import (
    bleu_scores, cider, ptb_tokenize, rouge_l,
)

PROMPT = "Provide a one-sentence caption for the provided video."


def remove_nonascii(text: str) -> str:
    return "".join(c if ord(c) < 128 else " " for c in text)


def doc_to_visual(doc, data_root: str = ""):
    path = os.path.join(data_root, doc["video_path"])
    if os.path.exists(path):
        return path
    raise FileNotFoundError(path)


def doc_to_text(doc, prompt: str = PROMPT):
    return prompt


def process_results(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    return {"answer": remove_nonascii(doc["sentence"]),
            "pred": remove_nonascii(pred),
            "video": doc["youtube_id"],
            "timestamp": doc.get("segment")}


def aggregate(records: List[dict]) -> Dict[str, float]:
    by_video = defaultdict(list)
    for r in records:
        by_video[r["video"]].append(r)
    per_video = defaultdict(list)
    for vid, recs in by_video.items():
        gts = {i: [ptb_tokenize(r["answer"])] for i, r in enumerate(recs)}
        res = {i: [ptb_tokenize(r["pred"])] for i, r in enumerate(recs)}
        bleus = bleu_scores(gts, res)
        # reference quirk: every Bleu_n aggregates np.mean([b1..b4])
        per_video["Bleu"].append(mean(bleus))
        per_video["ROUGE_L"].append(rouge_l(gts, res))
        per_video["CIDEr"].append(cider(gts, res))
    if not per_video:
        return {f"youcook2_{m}": 0.0
                for m in ("Bleu_4", "Bleu_3", "Bleu_2", "Bleu_1",
                          "ROUGE_L", "CIDEr")}
    out = {}
    for n in (4, 3, 2, 1):
        out[f"youcook2_Bleu_{n}"] = 100.0 * mean(per_video["Bleu"])
    out["youcook2_ROUGE_L"] = 100.0 * mean(per_video["ROUGE_L"])
    out["youcook2_CIDEr"] = 100.0 * mean(per_video["CIDEr"])
    return out


register_task(Task(
    name="youcook2_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=lambda data_root, split="val": __import__(
        "videoitg_tpu_torch.eval.loaders", fromlist=["load_benchmark_docs"]
    ).load_benchmark_docs("lmms-lab/YouCook2", data_root, split),
    doc_id_key=None,
    primary_metric="youcook2_CIDEr",
    generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                       "do_sample": False},
))
