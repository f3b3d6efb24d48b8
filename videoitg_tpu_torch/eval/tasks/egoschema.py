"""EgoSchema task, generation variant (parity: lmms_eval/tasks/egoschema).

Docs: video_idx / question / option (5 texts) / answer (int index; -1 on
the blind test split). Prompt appends the option lines and the standard
letter instruction (utils.py:50-66); scoring parses with the MMMU
multi-choice parser and compares indices (utils.py:179-189). The subset
split carries answers and reports accuracy; full-split rows without
answers aggregate into a submission mapping in the records.
"""

from __future__ import annotations

import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.extraction import parse_multi_choice_mmmu

_OPTIONS = ["A", "B", "C", "D", "E"]


def doc_to_visual(doc, data_root: str = ""):
    name = doc["video_idx"] + ".mp4"
    p = os.path.join(data_root, "videos", name) if data_root else name
    if not os.path.exists(p) and os.path.exists(p.replace("mp4", "MP4")):
        p = p.replace("mp4", "MP4")
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    question = doc["question"]
    if "option" in doc:
        for op in doc["option"]:
            question += "\n" + op
        post_prompt = "\nAnswer with the option's letter from the given choices directly."
    return f"{pre_prompt}{question}{post_prompt}"


def process_results(doc, response: str) -> dict:
    index2ans = {_OPTIONS[i]: doc["option"][i].strip() for i in range(5)}
    parsed = parse_multi_choice_mmmu(response, _OPTIONS, index2ans,
                                     seed=doc.get("video_idx"))
    pred = {"A": 0, "B": 1, "C": 2, "D": 3, "E": 4}.get(parsed, -1)
    return {
        "video_idx": doc["video_idx"],
        "pred": pred,
        "ground_truth": doc.get("answer", -1),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    scored = [r for r in records if r["ground_truth"] >= 0]
    if not scored:
        return {"egoschema_accuracy": 0.0}
    acc = 100.0 * sum(r["pred"] == r["ground_truth"] for r in scored) / len(scored)
    return {"egoschema_accuracy": acc}


def load_docs(data_root: str, split: str = "Subset") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/egoschema", data_root, split)


register_task(Task(
    name="egoschema_subset",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key="video_idx",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))
