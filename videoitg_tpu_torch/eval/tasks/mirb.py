"""MIRB — Multi-Image Relational Benchmark (parity:
lmms_eval/tasks/mirb/utils.py + mirb.yaml).

Multi-image reasoning over 11 subsets (VLLMs/MIRB-hf, split test). The
prompt prepends a per-subset instruction (get_task_instruction,
utils.py:12-24) between pre/post prompts; visuals are the doc's
image_list. Scoring branches on the GOLD answer (utils.py:196-205): a
bare letter A-E means MCQ (prefix-letter extraction,
parse_multi_choice_response, utils.py:107-121), anything else is open
(the MMMU open parser/normalizer chain — shared with
eval/tasks/mmmu.py, which hand-ports the same MMMU eval_utils the
reference vendors). Aggregation (utils.py:255-296): micro average over
docs ("mirb_score"), plus per-subset means and the four dimension
rollups (Knowledge/Reasoning/Perception/Multi-Hop — macro over their
subsets), which the reference prints but does not return.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.mmmu import (
    eval_open,
    parse_open_response,
)

INSTRUCTIONS = {
    # utils.py:12-24
    **{k: "Answer with a single word."
       for k in ("analogy", "attribute", "plot_code", "visual_chain",
                 "sightseeing")},
    **{k: "Answer with the option symbol."
       for k in ("codeu", "food", "image_jigsaw")},
    "arxiv": "Answer with the paper title.",
    "count": "Answer with a single number.",
    "3d_scene": ("The following images are different views of the same 3D "
                 "scene. Answer with a single number."),
}

# utils.py:284
DIMENSION_GROUPS = {
    "Knowledge": ["food", "sightseeing"],
    "Reasoning": ["codeu", "plot_code", "analogy", "3d_scene"],
    "Perception": ["image_jigsaw", "count", "attribute"],
    "Multi-Hop": ["visual_chain", "arxiv"],
}

_OPTION_LETTER_RE = re.compile(r"^\s*([A-Z])\.")


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    """utils.py:27-32."""
    instr = INSTRUCTIONS[doc["subset"]]
    return f"{pre_prompt}{instr}{doc['questions']}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:35-37 — the doc carries a LIST of images."""
    import os

    out = []
    for img in doc["image_list"]:
        if hasattr(img, "convert"):
            out.append(img)
            continue
        p = os.path.join(data_root, img) if data_root else img
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def parse_multi_choice_response(response: str) -> str:
    """utils.py:107-121 — NOT the MMMU bracketed parser: only a leading
    "X." option letter is extracted, otherwise the raw response stands."""
    m = _OPTION_LETTER_RE.match(response)
    return m.group(1) if m else response


def process_results(doc, response: str) -> dict:
    """utils.py:196-205."""
    answer = doc["answers"]
    if answer in ("A", "B", "C", "D", "E"):
        parsed = parse_multi_choice_response(response)
    else:
        parsed = parse_open_response(response)
    return {"question_id": doc["question_id"], "subset": doc["subset"],
            "pred_answer": parsed, "answers": answer}


def _is_correct(rec: dict) -> bool:
    """utils.py:264-271 — MCQ exact letter match; open via MMMU
    eval_open over the normalized candidate list."""
    if rec["answers"] in ("A", "B", "C", "D", "E"):
        return rec["pred_answer"] == rec["answers"]
    return eval_open(rec["answers"], rec["pred_answer"])


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:255-305."""
    if not records:
        return {"mirb_score": 0.0}
    by_subset: Dict[str, list] = {}
    hits = 0
    for r in records:
        ok = float(_is_correct(r))
        hits += ok
        by_subset.setdefault(r["subset"], []).append(ok)
    out = {"mirb_score": hits / len(records)}
    subset_avg = {k: sum(v) / len(v) for k, v in by_subset.items()}
    for k, v in sorted(subset_avg.items()):
        out[f"mirb_{k}"] = v
    for dim, subsets in DIMENSION_GROUPS.items():
        have = [subset_avg[s] for s in subsets if s in subset_avg]
        if have:
            out[f"mirb_dim_{dim}"] = sum(have) / len(have)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("VLLMs/MIRB-hf", data_root, split)


register_task(Task(
    name="mirb",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc["answers"],
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="mirb_score",
    load_docs=load_docs,
    doc_id_key="question_id",
    generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                       "do_sample": False},
    prompt_overrides={"default": {"pre_prompt": "", "post_prompt": ""}},
))
