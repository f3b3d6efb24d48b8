"""CinePile movie-QA task (subtitled 5-way MCQ).

Parity: lmms_eval/tasks/cinepile/ — docs carry videoID / question /
choices (5) / answer_key / answer_key_position / subtitles /
question_category / hard_split. The prompt embeds the scene subtitles,
the "- A) ..." option list, and the strict answer-format instructions
(cinepile.yaml lmms_eval_specific_kwargs, utils.py:cinepile_doc_to_text);
scoring normalizes "Answer: X) text"-style responses and matches option
letter and (when present) option text (utils.py:normalize_string +
evaluate_semantic_similarity); aggregation is overall accuracy with
per-category / hard-split rollups (utils.py:cinepile_aggregate_results).
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from videoitg_tpu_torch.eval.api import Task, register_task

PRE_PROMPT = (
    "You will be provided with subtitles from a specific scene of a movie "
    "and all the video frames from that scene. After going through the "
    "movie scene and seeing the frames, please answer the question that "
    "follows. The question will have five possible answers labeled A, B, "
    "C, D, and E, please try to provide the most probable answer in your "
    "opinion. Your output should be just one of A,B,C,D,E and nothing "
    "else.\n**Output Format:**\n\t**Answer:** <Option_key>")
POST_PROMPT = (
    "Note: Follow the output format strictly. Only answer with the option "
    "key (A, B, C, D, E) and nothing else.")

ANS_KEY_MAP = {0: "A", 1: "B", 2: "C", 3: "D", 4: "E"}


def doc_to_visual(doc, data_root: str = ""):
    base = data_root or "."
    path = os.path.join(base, doc["videoID"] + ".mp4")
    for cand in (path, path.replace("mp4", "MP4"), path.replace("mp4", "mkv")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def format_question_and_options(question: str, options: List[str]) -> str:
    out = f"{question}\n"
    for i, option in enumerate(options):
        out += f"- {chr(ord('A') + i)}) {option}\n"
    return out


def doc_to_text(doc, pre_prompt: str = PRE_PROMPT,
                post_prompt: str = POST_PROMPT) -> str:
    formatted = format_question_and_options(doc["question"], doc["choices"])
    return (f"{pre_prompt}\n\n**Subtitles:**\n{doc['subtitles']}\n\n"
            f"{formatted}\n{post_prompt}")


def normalize_string(s: str) -> Tuple[Optional[str], str]:
    """("X", text) from "Answer: X) text" / bare-letter responses
    (reference utils.py:normalize_string)."""
    s = s.replace("*", "").strip()
    if re.match(r"^[A-E]$", s, re.IGNORECASE):
        return s.upper(), ""
    m = re.search(r"Answer:\s*([A-E])\)?\.?\s*(.*)", s, re.IGNORECASE)
    if m:
        return m.group(1).upper(), m.group(2).strip()
    return None, s.strip()


def eval_response(response: str, answer_letter: str, answer_text: str):
    """(correct, parsed_letter, parsed_text) — letter must match; when both
    sides carry option text it must match too (reference
    evaluate_semantic_similarity)."""
    letter, text = normalize_string(response)
    if answer_letter and letter:
        if answer_letter == letter:
            if answer_text and text:
                return (int(answer_text.lower() == text.lower()), letter, text)
            return (1, letter, text)
    elif answer_text.lower() == text.lower():
        return (1, letter, text)
    return (0, letter, text)


def process_results(doc, response: str) -> dict:
    answer = ANS_KEY_MAP[doc["answer_key_position"]]
    correct, letter, text = eval_response(response, answer, doc["answer_key"])
    return {
        "question_category": doc.get("question_category"),
        "hard_split": str(doc.get("hard_split")),
        "correct": correct,
        "answer": answer,
        "response_ext_number": letter,
        "response_ext_text": text,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"cinepile_accuracy": 0.0}
    total = sum(r["correct"] for r in records)
    out = {"cinepile_accuracy": 100.0 * total / len(records)}
    by_cat = defaultdict(list)
    by_hard = defaultdict(list)
    for r in records:
        by_cat[r["question_category"]].append(r["correct"])
        by_hard[r["hard_split"]].append(r["correct"])
    for cat, vals in sorted(by_cat.items(), key=lambda kv: str(kv[0])):
        key = re.sub(r"\W+", "_", str(cat)).strip("_").lower()
        out[f"cinepile_{key}"] = 100.0 * sum(vals) / len(vals)
    for hs, vals in sorted(by_hard.items()):
        out[f"cinepile_hard_{hs.lower()}"] = 100.0 * sum(vals) / len(vals)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("tomg-group-umd/cinepile", data_root, split)


register_task(Task(
    name="cinepile",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="cinepile_accuracy",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
