"""CG-Bench subtitles task (parity: lmms_eval/tasks/cgbench/utils.py:54-130).

Docs: video_uid / question / choices / answer / sub_category. The prompt
prepends subtitle lines selected by frame overlap with uniformly-sampled
frames (SRT parsed from <data_root>/cg_subtitles/<uid>.srt). Letters run
A.. beyond D (7 choices occur), so extraction uses A-H.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List

import numpy as np

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.extraction import extract_choice_letter


def parse_srt(path: str) -> List[tuple]:
    """[(start_sec, end_sec, text)] from an SRT file."""
    out = []
    with open(path, encoding="utf-8", errors="replace") as f:
        blocks = f.read().split("\n\n")
    ts = re.compile(
        r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
    for block in blocks:
        m = ts.search(block)
        if not m:
            continue
        g = [int(x) for x in m.groups()]
        start = g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000.0
        end = g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000.0
        lines = [ln.strip() for ln in block.splitlines()
                 if ln.strip() and not ts.search(ln) and not ln.strip().isdigit()]
        if lines:
            out.append((start, end, " ".join(lines)))
    return out


def subtitles_for_sampled_frames(video_path: str, subtitle_path: str,
                                 frame_num: int = 32) -> str:
    """Subtitle lines overlapping uniformly-sampled frame indices
    (reference cgbench utils extract_subtitles + frame-overlap selection)."""
    from videoitg_tpu_torch.data.video import VideoReader

    with VideoReader(video_path) as vr:
        fps, total_frame = vr.fps, len(vr)
    subs = parse_srt(subtitle_path)
    by_frame = [(int(s * fps), int(e * fps), t) for s, e, t in subs]
    if frame_num == -1:
        frame_num = total_frame
    sampled = np.linspace(0, total_frame - 1, frame_num, dtype=int).tolist()
    chosen = []
    for fi in sampled:
        for idx, (s, e, _t) in enumerate(by_frame):
            if s <= fi < e:
                chosen.append(idx)
    return "\n".join(by_frame[i][2] for i in sorted(set(chosen)))


def doc_to_visual(doc, data_root: str = ""):
    p = os.path.join(data_root, doc["video_uid"] + ".mp4")
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, data_root: str = "", frame_num: int = 32, **_):
    subtitle = "No subtitles available"
    if data_root:
        sub_path = os.path.join(data_root, "cg_subtitles", doc["video_uid"] + ".srt")
        video_path = os.path.join(data_root, doc["video_uid"] + ".mp4")
        if os.path.exists(sub_path):
            try:
                text = subtitles_for_sampled_frames(video_path, sub_path, frame_num)
                subtitle = text or "No subtitles available"
            except Exception:
                subtitle = "No subtitles available"
    option_prompt = ("Select the best answer to the following multiple-choice "
                     "question based on the video and the subtitles. Respond "
                     "with only the letter of the correct option.")
    options = "\n".join(f"{chr(65 + i)}. {o}" for i, o in enumerate(doc["choices"]))
    question = doc["question"] + "\n" + options
    return ("This video's subtitles are listed below: \n" + subtitle + "\n" +
            option_prompt + "\n" + question + "\n" + "The best answer is:")


def process_results(doc, response: str) -> dict:
    return {
        "sub_category": doc.get("sub_category"),
        "pred_answer": extract_choice_letter(response, letters="ABCDEFGH"),
        "answer": doc["answer"],
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    correct = sum(r["pred_answer"] == r["answer"] for r in records)
    out = {"cgbench_perception_score": 100.0 * correct / len(records) if records else 0.0}
    by_cat = defaultdict(lambda: [0, 0])
    for r in records:
        by_cat[r["sub_category"]][0] += int(r["pred_answer"] == r["answer"])
        by_cat[r["sub_category"]][1] += 1
    for cat, (c, a) in sorted(by_cat.items(), key=lambda kv: str(kv[0])):
        out[f"cgbench_{cat}"] = 100.0 * c / a if a else 0.0
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("CG-Bench/CG-Bench", data_root, split)


register_task(Task(
    name="cgbench_subtitles",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))
