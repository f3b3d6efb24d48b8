"""Video-MME task (parity: lmms_eval/tasks/videomme/).

Docs carry videoID / question / options / answer / duration / domain /
sub_category / task_type. The headline metric is overall accuracy; the
aggregator also reports per-duration rollups (short/medium/long), matching
the reference's printed breakdown (utils.py:283-350).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.extraction import extract_choice_letter

VIDEO_TYPE = ["short", "medium", "long"]


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "data") if data_root else "data"
    video_path = os.path.join(base, doc["videoID"] + ".mp4")
    for cand in (video_path, video_path.replace("mp4", "MP4"),
                 video_path.replace("mp4", "mkv")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(video_path)


def doc_to_text(doc, post_prompt: str = "Please respond with only the letter of the correct answer.") -> str:
    option_prompt = (
        "Select the best answer to the following multiple-choice question "
        "based on the video and the subtitles. Respond with only the letter "
        "(A, B, C, or D) of the correct option."
    )
    question = doc["question"] + "\n" + "\n".join(doc["options"])
    return option_prompt + "\n" + question + "\n" + post_prompt


def process_results(doc, response: str) -> dict:
    return {
        "question_id": doc.get("question_id"),
        "duration": doc["duration"],
        "category": doc.get("domain"),
        "sub_category": doc.get("sub_category"),
        "task_category": doc.get("task_type"),
        "pred_answer": extract_choice_letter(response),
        "answer": doc["answer"],
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    by_duration = defaultdict(lambda: [0, 0])
    correct = answered = 0
    for r in records:
        ok = int(r["pred_answer"] == r["answer"])
        correct += ok
        answered += 1
        by_duration[r["duration"]][0] += ok
        by_duration[r["duration"]][1] += 1
    out = {
        "videomme_perception_score": 100.0 * correct / answered if answered else 0.0
    }
    for d in VIDEO_TYPE:
        c, a = by_duration.get(d, (0, 0))
        out[f"videomme_{d}"] = 100.0 * c / a if a else 0.0
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    """Local-first (parquet/json under data_root), else the HF hub id."""
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/Video-MME", data_root, split)


def doc_to_text_subtitle(doc, data_root: str = "", frame_num: int = 32) -> str:
    """Prompt variant with frame-aligned subtitle lines (parity:
    videomme/utils.py:174-229 — Video-MME SRTs wrap text in a
    <font color="white" size=".72c"> tag, extracted per overlapping line)."""
    import re

    subtitle = "No subtitles available"
    if data_root:
        sub_path = os.path.join(data_root, "subtitle", doc["videoID"] + ".srt")
        try:
            video_path = doc_to_visual(doc, data_root=data_root)
        except FileNotFoundError:
            video_path = None
        if video_path and os.path.exists(sub_path):
            try:
                from videoitg_tpu_torch.eval.tasks.cgbench import (
                    subtitles_for_sampled_frames,
                )

                text = subtitles_for_sampled_frames(video_path, sub_path, frame_num)
                # Video-MME SRT lines carry a font tag; lines without it are
                # DROPPED, exactly like the reference (utils.py:214-220).
                lines = []
                for ln in text.splitlines():
                    m = re.findall(r'<font color="white" size=".72c">(.*?)</font>', ln)
                    if m:
                        lines.append(m[0])
                subtitle = "\n".join(lines) or "No subtitles available"
            except Exception:
                subtitle = "No subtitles available"
    option_prompt = (
        "Select the best answer to the following multiple-choice question "
        "based on the video and the subtitles. Respond with only the letter "
        "(A, B, C, or D) of the correct option."
    )
    question = doc["question"] + "\n" + "\n".join(doc["options"])
    return ("This video's subtitles are listed below: \n" + subtitle + "\n"
            + option_prompt + "\n" + question + "\n" + "The best answer is:")


# Per-model prompt variants (reference videomme.yaml:26-41
# lmms_eval_specific_kwargs): the default post_prompt plus the gpt4v /
# llava_vid styles; adapters pick theirs by registry name.
PROMPT_OVERRIDES = {
    "default": {"post_prompt": "Please respond with only the letter of the correct answer."},
    "gpt4v": {"post_prompt": "Answer the question with A, B, C, or D."},
    "llava_vid": {"post_prompt": "The best answer is:"},
}

register_task(Task(
    name="videomme",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
    prompt_overrides=PROMPT_OVERRIDES,
))

register_task(Task(
    name="videomme_w_subtitle",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text_subtitle,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))
