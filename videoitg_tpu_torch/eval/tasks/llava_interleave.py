"""LLaVA-NeXT-Interleave-Bench (parity: lmms_eval/tasks/
llava_interleave_bench/utils.py + in_domain/out_of_domain/
multi_view_in_domain yamls).

Multi-image interleaved QA (lmms-lab/LLaVA-NeXT-Interleave-Bench,
configs in_domain / out_of_domain / multi_view_in_domain, split test).
Visuals are the doc's image_0..image_15 columns in order, skipping
Nones (utils.py:36-55). Prompts: the question, with MCQ docs optionally
truncated at "Your answer is:" + first line when an mcq_post_prompt is
configured (utils.py:59-80); the multi_view config sends the raw
conversations payload instead (doc_to_text_conversation,
utils.py:83-94 — lists are json.dumps'd).

Scoring (utils.py:104-183): multi-choice via mcq_acc (VQA-style
punctuation strip then option-letter match); open-ended via the `rouge`
package's ROUGE-L f between prediction (truncated to 512 chars) and
answer. Aggregation (utils.py:186-233): sub_tasks roll into 18 named
categories; the overall score is the MACRO mean over categories that
appeared (reference raises when nothing matched; empty-record runs
return 0 here since the harness reports per-task zeros instead of
crashing a sweep).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

# utils.py:14-33
CATEGORIES = {
    "Spot-the-Diff": ["Spot-the-Diff", "Birds-to-Words", "CLEVR-Change"],
    "Image-Edit": ["IEdit", "HQ-Edit", "MagicBrush"],
    "Visual-Story-Telling": ["AESOP", "FlintstonesSV", "PororoSV", "VIST"],
    "Visual-Cloze": ["COMICS_Dialogue", "RecipeQA_VisualCloze"],
    "Text-Rich-VQA": ["WebQA", "TQA", "OCR-VQA", "DocVQA"],
    "Multi-Image-VQA": ["MIT-States_StateCoherence",
                        "MIT-States_PropertyCoherence", "VISION",
                        "RecipeQA_ImageCoherence"],
    "Puzzle": ["RAVEN"],
    "NLVR2": ["NLVR2_Mantis"],
    "QBench": ["QBench"],
    "ScanQA": ["ScanQA"],
    "ALFRED": ["ALFRED"],
    "nuscenes": ["nuscenes"],
    "ScanNet_chat": ["ScanNet_chat"],
    "ScanNet_task": ["ScanNet_task"],
    "BLINK": ["BLINK"],
    "MathVerse": ["MathVerse"],
    "SciVerse": ["SciVerse"],
    "Mantis": ["Mantis"],
}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]
_OPTION_RE = re.compile(r"^([A-E])\.\s*(.+)$", re.IGNORECASE)
_LETTER_RE = re.compile(r"\b([A-E])\b", re.IGNORECASE)


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:36-55 — image_0..image_15, Nones skipped."""
    visuals = []
    for i in range(16):
        img = doc.get(f"image_{i}")
        if img is None:
            continue
        visuals.append(img)
    return visuals


def doc_to_text(doc, oe_post_prompt: str = "",
                mcq_post_prompt: str = "") -> str:
    """utils.py:59-80."""
    user_prompt = doc["question"]
    if mcq_post_prompt and doc["question_type"] == "multi-choice":
        user_prompt = (user_prompt.split("Your answer is:")[0]
                       .split("\n")[0].strip())
        user_prompt = f"{user_prompt}\n{mcq_post_prompt}"
    if oe_post_prompt and doc["question_type"] == "open-ended":
        user_prompt = f"{user_prompt}\n{oe_post_prompt}"
    return user_prompt


def doc_to_text_conversation(doc, oe_post_prompt: str = "",
                             mcq_post_prompt: str = "") -> str:
    """utils.py:83-94 (multi_view config)."""
    conversations = doc["conversations"]
    if isinstance(conversations, list):
        return json.dumps(conversations)
    return conversations


def _process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) \
                or _COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def _mcq_canon(answer: str) -> str:
    """utils.py:137-161 — leading "X." wins, else strip punctuation and
    hunt for a standalone letter."""
    m = _OPTION_RE.match(answer.strip())
    if m:
        return m.group(1).upper()
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = _process_punctuation(answer)
    answer = answer.strip("'").strip('"').strip(")").strip("(")
    answer = answer.strip().lower()
    lm = _LETTER_RE.search(answer)
    if lm:
        return lm.group(1).upper()
    return answer


def mcq_acc(answer: str, pred: str) -> int:
    """utils.py:122-171."""
    return int(_mcq_canon(pred) == _mcq_canon(answer))


def oe_rouge(answer: str, pred: str) -> float:
    """utils.py:174-183 — `rouge` package ROUGE-L f, pred capped at
    512 chars, empty pred scores 0."""
    from rouge import Rouge

    if pred == "":
        return 0.0
    if len(pred) > 512:
        pred = pred[:512]
    return Rouge().get_scores(pred, answer)[0]["rouge-l"]["f"]


def process_results(doc, response: str) -> dict:
    """utils.py:104-119."""
    qtype = doc["question_type"]
    if qtype == "multi-choice":
        score = mcq_acc(doc["answer"], response)
    elif qtype == "open-ended":
        score = oe_rouge(doc["answer"], response)
    else:
        raise ValueError(f"Unknown question type: {qtype}")
    return {"sample_id": doc["sample_id"], "sub_task": doc["sub_task"],
            "question_type": qtype, "answer": doc["answer"],
            "parsed_pred": response, "score": score}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:186-233 — macro over matched categories."""
    if not records:
        return {"overall_score": 0.0}
    cat_scores: Dict[str, float] = {}
    out: Dict[str, float] = {}
    for cat, subtasks in CATEGORIES.items():
        vals = [r["score"] for r in records if r["sub_task"] in subtasks]
        if vals:
            cat_scores[cat] = sum(vals) / len(vals)
    for cat, v in cat_scores.items():
        out[f"interleave_{cat}"] = v
    out["overall_score"] = (sum(cat_scores.values()) / len(cat_scores)
                            if cat_scores else 0.0)
    return {"overall_score": out.pop("overall_score"), **out}


def _make_load(subset: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/LLaVA-NeXT-Interleave-Bench",
                                   data_root, split, subset=subset)
    return load_docs


_GEN = {"max_new_tokens": 16, "temperature": 0, "do_sample": False}

for _name, _subset, _text in (
        ("llava_interleave_bench_in_domain", "in_domain", doc_to_text),
        ("llava_interleave_bench_out_domain", "out_of_domain", doc_to_text),
        ("llava_interleave_bench_multi_view", "multi_view_in_domain",
         doc_to_text_conversation)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_text,
        doc_to_target=lambda doc: doc["answer"],
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="overall_score",
        load_docs=_make_load(_subset),
        doc_id_key="sample_id",
        generation_kwargs=dict(_GEN),
        prompt_overrides={"default": {"oe_post_prompt": "",
                                      "mcq_post_prompt": ""}},
    ))

register_group("llava_interleave_bench", [
    "llava_interleave_bench_in_domain",
    "llava_interleave_bench_out_domain",
    "llava_interleave_bench_multi_view",
])
