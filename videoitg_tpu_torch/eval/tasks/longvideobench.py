"""LongVideoBench val_v task (parity: lmms_eval/tasks/longvideobench/utils.py).

Docs: video_path / question / option0..option4 ("N/A" truncates) /
correct_choice (int) / duration_group / question_category / id. Failed
parses get a deterministic pseudo-random choice (the reference uses
random.choice per the original paper; we seed per-doc so reruns agree).
"""

from __future__ import annotations

import os
import random
import re
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

ANSWER_PREFIXES = [
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is", "The correct option is",
    "Best answer:", "Best option:",
]


def doc_to_visual(doc, data_root: str = ""):
    p = os.path.join(data_root, doc["video_path"]) if data_root else doc["video_path"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "Answer with the option's letter from the given choices directly.") -> str:
    candidates = []
    for i in range(5):
        c = doc.get(f"option{i}")
        if c is not None and c != "N/A":
            candidates.append(c)
    question = doc["question"] + "\n" + "\n".join(
        f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(candidates)
    )
    return f"{pre_prompt}{question}\n{post_prompt}"


def timestamp_to_seconds(timestamp: str) -> float:
    """"HH:MM:SS.frac" -> seconds (reference utils.py:21-26)."""
    h, m, s = timestamp.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


def compute_frame_timestamps(duration: float, max_num_frames: int = 16) -> List[float]:
    """Uniform frame timestamps (reference utils.py:49-53)."""
    if duration > max_num_frames:
        return [duration / max_num_frames * i for i in range(max_num_frames)]
    return [float(i) for i in range(int(duration))]


def insert_subtitles_into_frames(
    frame_timestamps: List[float], subtitles: List[dict],
    starting_timestamp_for_subtitles: float, duration: float,
) -> str:
    """Interleave subtitle lines between <image> slots by midpoint time.

    Parity: reference utils.py:56-143 — handles BOTH subtitle schemas
    ({"timestamp": [start, end], "text"} with a possibly-null end, and
    {"start": "HH:MM:SS", "end": ..., "line"}), widens sub-1s windows to 1s,
    and drops subtitles that cover no sampled frame."""
    interleaved: List[str] = []
    cur_i = 0
    for subtitle in subtitles:
        if "timestamp" in subtitle:
            start, end = subtitle["timestamp"]
            if not isinstance(end, float):
                end = duration
            text = subtitle["text"]
        else:
            start = timestamp_to_seconds(subtitle["start"])
            end = timestamp_to_seconds(subtitle["end"])
            text = subtitle["line"]
        start -= starting_timestamp_for_subtitles
        end -= starting_timestamp_for_subtitles
        mid = (start + end) / 2

        for ts in frame_timestamps[cur_i:]:
            if ts <= mid:
                interleaved.append("<image>")
                cur_i += 1
            else:
                break

        if end - start < 1:
            start, end = mid - 0.5, mid + 0.5
        if any(start < ts < end for ts in frame_timestamps):
            interleaved.append(text)
    interleaved.extend("<image>" for _ in frame_timestamps[cur_i:])
    return "\n".join(interleaved)


def doc_to_text_interleaved(
    doc, data_root: str = "", pre_prompt: str = "",
    post_prompt: str = "Answer with the option's letter from the given choices directly.",
    subtitle_subdir: str = "subtitles", max_num_frames: int = 16,
) -> str:
    """val_i variant: subtitles interleaved between frame slots
    (reference utils.py:117-141; subtitle jsons live beside the videos)."""
    import json as _json

    question = doc_to_text(doc, pre_prompt="", post_prompt="").rsplit("\n", 1)[0]
    with open(os.path.join(data_root, subtitle_subdir, doc["subtitle_path"])) as f:
        subtitles = _json.load(f)
    frame_timestamps = compute_frame_timestamps(doc["duration"], max_num_frames)
    prefix = insert_subtitles_into_frames(
        frame_timestamps, subtitles, doc["starting_timestamp_for_subtitles"],
        doc["duration"])
    return f"{pre_prompt}{prefix}\n{question}\n{post_prompt}"


def parse_multi_choice_response(response: str, all_choices: List[str], seed) -> str:
    s = response.strip()
    for p in ANSWER_PREFIXES:
        s = s.replace(p, "")
    rng = random.Random(str(seed))
    if len(s.split()) > 10 and not re.search("[ABCDE]", s):
        return rng.choice(all_choices)
    m = re.search(r"[ABCDE]", s)
    if m is None:
        return rng.choice(all_choices)
    return m[0]


def process_results(doc, response: str) -> dict:
    all_choices = []
    for i in range(5):
        if doc.get(f"option{i}") in (None, "N/A"):
            break
        all_choices.append(chr(ord("A") + i))
    parsed = parse_multi_choice_response(response, all_choices or ["A"], doc.get("id"))
    return {
        "id": doc.get("id"),
        "duration_group": doc.get("duration_group"),
        "question_category": doc.get("question_category"),
        "answer": chr(ord("A") + doc["correct_choice"]),
        "parsed_pred": parsed,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    correct = sum(r["parsed_pred"] == r["answer"] for r in records)
    out = {"lvb_acc": correct / len(records) if records else 0.0}
    by_dur = defaultdict(lambda: [0, 0])
    for r in records:
        by_dur[r["duration_group"]][0] += int(r["parsed_pred"] == r["answer"])
        by_dur[r["duration_group"]][1] += 1
    for d, (c, a) in sorted(by_dur.items(), key=lambda kv: str(kv[0])):
        out[f"lvb_acc_duration_{d}"] = c / a if a else 0.0
    return out


def load_docs(data_root: str, split: str = "validation") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("longvideobench/LongVideoBench", data_root, split)


# val_i is a DOWNSTREAM-prompt task: the interleaved "<image>" slots are per
# frame and consumed by stage-B adapters; the grounding stage (single image
# block) runs on val_v — matching the reference, whose videoitg wrapper was
# never pointed at val_i.
register_task(Task(
    name="longvideobench_val_i",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text_interleaved,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="id",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))

register_task(Task(
    name="longvideobench_val_v",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="id",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))
