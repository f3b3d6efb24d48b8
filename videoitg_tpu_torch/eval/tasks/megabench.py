"""MEGA-Bench (parity: lmms_eval/tasks/megabench/utils.py +
image_video_utils.py + the four yamls; scoring via
videoitg_tpu/eval/megabench/ — the port of the reference's standalone
evaluator.py that its README step 2 runs over the submission file).

Four tasks over TIGER-Lab/MEGA-Bench (split test): megabench_core /
megabench_open (multi-image subsets) and the *_si single-image
variants. Each doc carries task_name / task_description / example_text
/ query_text, three media lists (global/example/query, stringified),
answer, metric_info (the task's scoring config) and eval_context.

Prompting (utils.py:47-57): description + example + query joined by
newlines when the media are homogeneous; MIXED image+video docs
subsample each video to max_video_subsample_frame frames and replace
its <video> placeholder with "[video start]<image>...[video end]"
(image_video_utils.py:103-136 — videos decode through the in-tree
libav reader instead of cv2).

Scoring: process_results keeps the reference's submission record
(utils.py:80-99) AND — because this harness's load_docs hands the task
the full row including metric_info — scores each query inline with the
ported evaluator. aggregate reports the reference's summary numbers
(macro_mean_score over tasks, micro over queries, evaluator.py:246-260)
plus the submission count; the harness's per-sample JSONL is the
submission file.
"""

from __future__ import annotations

import os
from ast import literal_eval
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.megabench import score_query

MEDIA_KEYS = ("global_media", "example_media", "query_media")


def _media_list(value) -> list:
    if isinstance(value, str):
        return literal_eval(value) if value.strip() else []
    return list(value or [])


def _all_media(doc) -> list:
    from itertools import chain

    return list(chain.from_iterable(_media_list(doc[k])
                                    for k in MEDIA_KEYS))


def is_video_file(file_path: str) -> bool:
    """image_video_utils.py:71-75."""
    from mimetypes import guess_type

    mime_type, _ = guess_type(file_path)
    return bool(mime_type) and mime_type.startswith("video")


def _check_media_type(doc):
    """utils.py:32-44."""
    media = _all_media(doc)
    is_video = [is_video_file(f) for f in media]
    if not any(is_video):
        return "image", media
    if all(is_video):
        return "video", media
    return "mixed", media


def _subsample_video(path: str, max_nframes: int) -> list:
    """image_video_utils.py:28-68 via the in-tree libav decoder: all
    frames when short, else linspace-uniform max_nframes."""
    from videoitg_tpu_torch.data.video import VideoReader

    with VideoReader(path) as vr:
        total = len(vr)
        if total <= 0:
            raise ValueError(f"Failed to read video from {path}")
        if total <= max_nframes:
            idx = list(range(total))
        else:
            idx = [round(i * (total - 1) / (max_nframes - 1))
                   for i in range(max_nframes)]
        frames = vr.get_batch(idx)
    from PIL import Image

    return [Image.fromarray(f) for f in frames]


def _resolve(path: str, data_root: str) -> str:
    p = os.path.join(data_root, path) if data_root else path
    return p


def _mixed_prompt_and_images(doc, max_nframes: int, data_root: str):
    """image_video_utils.py:93-136."""
    import re

    all_texts, all_images = [], []
    for text_key, media_key in (("task_description", "global_media"),
                                ("example_text", "example_media"),
                                ("query_text", "query_media")):
        text = doc[text_key]
        media_paths = [_resolve(p, data_root)
                       for p in _media_list(doc[media_key])]
        chunks = re.split(r"(<image>|<video>)", text)
        placeholder_count = sum(1 for c in chunks
                                if c in ("<image>", "<video>"))
        if placeholder_count != len(media_paths):
            raise ValueError(
                f"Mismatching # placeholders ({placeholder_count}) and "
                f"# media paths ({len(media_paths)})")
        media_index, texts = 0, []
        for chunk in chunks:
            if chunk in ("<image>", "<video>"):
                path = media_paths[media_index]
                if is_video_file(path):
                    frames = _subsample_video(path, max_nframes)
                    all_images.extend(frames)
                    texts.append("[video start]"
                                 + "<image>" * len(frames)
                                 + "[video end]")
                else:
                    all_images.append(path)
                    texts.append("<image>")
                media_index += 1
            elif chunk.strip():
                texts.append(chunk.strip())
        all_texts.append(" ".join(texts))
    return "\n".join(all_texts), all_images


# doc_to_text and doc_to_visual both need the mixed-media expansion; the
# harness calls them back-to-back per doc, so a single-slot memo avoids
# decoding every video twice (the reference's image_video_utils returns
# prompt and images together in one call). Keyed by the doc CONTENT the
# expansion reads (id() is unsafe: CPython reuses freed dict addresses
# across doc lists); single slot bounds pinned frames to one doc.
_MIXED_MEMO: dict = {}


def _mixed_memoized(doc, max_nframes: int, data_root: str):
    key = (tuple(str(doc.get(k)) for k in
                 ("id", "task_name", "task_description", "example_text",
                  "query_text") + MEDIA_KEYS),
           max_nframes, data_root)
    if _MIXED_MEMO.get("key") != key:
        # compute BEFORE committing the key: a raising expansion must not
        # pair this doc's key with the previous doc's value
        value = _mixed_prompt_and_images(doc, max_nframes, data_root)
        _MIXED_MEMO["key"], _MIXED_MEMO["value"] = key, value
    return _MIXED_MEMO["value"]


def doc_to_text(doc, max_video_subsample_frame: int = 64,
                data_root: str = "") -> str:
    """utils.py:47-57."""
    media_type, _ = _check_media_type(doc)
    if media_type in ("image", "video"):
        return "\n".join([doc["task_description"], doc["example_text"],
                          doc["query_text"]])
    prompt, _ = _mixed_memoized(doc, max_video_subsample_frame, data_root)
    return prompt


def doc_to_visual(doc, data_root: str = "",
                  max_video_subsample_frame: int = 64):
    """utils.py:60-73."""
    media_type, media = _check_media_type(doc)
    paths = [_resolve(p, data_root) for p in media]
    if media_type in ("image", "video"):
        return paths
    _, images = _mixed_memoized(doc, max_video_subsample_frame, data_root)
    return images


def process_results(doc, response: str) -> dict:
    """utils.py:80-99 (submission record) + inline scoring through the
    ported evaluator when the doc carries its metric_info."""
    rec = {
        "task_name": doc["task_name"],
        "global_idx": doc["id"],
        "eval_context": literal_eval(doc["eval_context"])
        if isinstance(doc.get("eval_context"), str)
        else (doc.get("eval_context") or {}),
        "images": _media_list(doc["query_media"]),
        "query_text": doc["query_text"],
        "global_images": _media_list(doc["global_media"]),
        "global_description": doc["task_description"],
        "example_info": {
            "image_paths": _media_list(doc["example_media"]),
            "example_text": doc["example_text"],
        },
        "correct_answer": literal_eval(doc["answer"])
        if isinstance(doc.get("answer"), str) else doc.get("answer"),
        "response": response,
    }
    metric_info = doc.get("metric_info")
    if metric_info:
        score_config = (literal_eval(metric_info)
                        if isinstance(metric_info, str) else metric_info)
        try:
            # "images" rides along for gpt_4o_as_judge "with image"
            # configs — the reference evaluator scores submission records
            # whose images are the raw query_media paths (evaluator.py
            # passes query["images"] into VLMJudgeScore.match).
            scores = score_query(
                {"response": response,
                 "correct_answer": rec["correct_answer"],
                 "query_text": rec["query_text"],
                 "images": rec["images"]},
                score_config, rec["eval_context"])
        except Exception as e:
            scores = {"field": {}, "info": {"error": str(e)},
                      "query": -1}
        rec["scores"] = scores
    return rec


def aggregate(records: List[dict]) -> Dict[str, float]:
    """evaluator.py:147-235 summary: negative (-1/unsupported) query
    scores are excluded from the NUMERATOR only — every query stays in
    both denominators (num_queries += 1 unconditionally at :148,
    mean = task_score_sum / len(query_response) at :198, macro over ALL
    tasks at :223) — matching scripts/megabench_score.py."""
    by_task = defaultdict(list)
    for r in records:
        by_task[r["task_name"]].append(r)
    task_means = []
    total_query_score = 0.0
    for task_name, recs in by_task.items():
        task_sum = sum(r["scores"]["query"] for r in recs
                       if "scores" in r and r["scores"]["query"] >= 0)
        task_means.append(task_sum / len(recs) if recs else 0.0)
        total_query_score += task_sum
    out = {
        "macro_mean_score": (sum(task_means) / len(by_task)
                             if by_task else 0.0),
        "micro_mean_score": (total_query_score / len(records)
                             if records else 0.0),
        "num_tasks": float(len(by_task)),
        "num_queries": float(len(records)),
    }
    return out


def _make_load(subset: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("TIGER-Lab/MEGA-Bench", data_root,
                                   split, subset=subset)
    return load_docs


_GEN = {"max_new_tokens": 2048, "temperature": 0, "do_sample": False,
        "top_p": 1.0}

for _name, _subset in (("megabench_core", "core"),
                       ("megabench_open", "open"),
                       ("megabench_core_si", "core_single_image"),
                       ("megabench_open_si", "open_single_image")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: str(doc.get("answer", "")),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="macro_mean_score",
        load_docs=_make_load(_subset),
        doc_id_key="id",
        generation_kwargs=dict(_GEN),
        prompt_overrides={"default":
                          {"max_video_subsample_frame": 64}},
    ))

register_group("megabench", ["megabench_core", "megabench_open",
                             "megabench_core_si", "megabench_open_si"])
