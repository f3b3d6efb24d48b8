"""MMT-Bench (parity: lmms_eval/tasks/mmt/utils.py +
_default_template_yaml + the 4 split yamls; groups mmt.yaml /
mmt_mi.yaml).

Massive multi-task MCQ: ``mmt_val`` / ``mmt_test``
(lmms-lab/MMT-Benchmark) and the multi-image arm ``mmt_mi_val`` /
``mmt_mi_test`` (lmms-lab/MMT_MI-Benchmark). Docs carry index /
question / option columns A..I (sparse) / answer / l2-category /
split / image (a LIST).

Parity:
* doc_to_text (utils.py:61-80): "Question: <image>\\n" + question +
  "A: text" option lines + post_prompt "\\nAnswer the question using a
  single character from the given options.".
* parse_multi_choice_response (utils.py:159-199 — the MMT variant of
  the MMMU parser: no option-text containment stage, multi-candidate
  tiebreak by LAST " X " occurrence; the no-candidate random.choice is
  a deterministic crc32 draw here, same convention as tasks/mmmu.py).
* scoring (utils.py:101-145): exact letter match; overall*100 +
  per-l2-category rollups. TEST splits additionally carry withheld
  answers upstream — submission rows are recoverable from
  samples.jsonl (index + parsed prediction per record).
"""

from __future__ import annotations

import re
import zlib
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

OPTION_COLUMNS = ("A", "B", "C", "D", "E", "F", "G", "H", "I")
POST_PROMPT = ("\nAnswer the question using a single character from the "
               "given options.")


def parse_multi_choice_response(response: str, all_choices: List[str],
                                doc_id: str = "") -> str:
    """utils.py:159-199 (random fallback -> crc32)."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "
    candidates = [c for c in all_choices if f"({c})" in response]
    if not candidates:
        candidates = [c for c in all_choices if f" {c} " in response]
    if not candidates:
        candidates = [c for c in all_choices if f"{c}." in response]
    if not candidates:
        seed = zlib.crc32(f"{doc_id}|{response}".encode())
        return all_choices[seed % len(all_choices)]
    if len(candidates) > 1:
        starts = [response.rfind(f" {c} ") for c in candidates]
        return candidates[max(range(len(candidates)),
                              key=lambda i: starts[i])]
    return candidates[0]


def doc_to_text(doc, pre_prompt: str = "",
                post_prompt: str = POST_PROMPT) -> str:
    q = "Question: <image>\n" + doc["question"].strip()
    options = [f"{o}: {doc[o].strip()}" for o in OPTION_COLUMNS
               if doc.get(o) and doc[o].strip()]
    return f"{pre_prompt}{q}\n" + "\n".join(options) + post_prompt


def doc_to_visual(doc, data_root: str = ""):
    import os

    images = doc["image"]
    if not isinstance(images, (list, tuple)):
        images = [images]
    out = []
    for v in images:
        if hasattr(v, "convert"):
            out.append(v)
            continue
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def process_results(doc, response: str) -> dict:
    all_choices = [c for c in OPTION_COLUMNS if doc.get(c)]
    pred = parse_multi_choice_response(response.strip(), all_choices,
                                       doc_id=str(doc.get("index", "")))
    gt = (doc.get("answer") or "").strip()
    return {"index": doc.get("index"), "pred": pred,
            "score": 1.0 if pred == gt else 0.0,
            "l2_category": doc.get("l2-category", "unknown")}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"mmt_accuracy": 0.0}
    by_cat = defaultdict(list)
    for r in records:
        by_cat[r["l2_category"]].append(r["score"])
    out = {"mmt_accuracy":
           round(100.0 * sum(r["score"] for r in records)
                 / len(records), 5)}
    for c, v in sorted(by_cat.items()):
        slug = re.sub(r"\W+", "_", str(c).lower()).strip("_")
        out[f"mmt_{slug}"] = round(100.0 * sum(v) / len(v), 5)
    return out


def _make_load(hub: str, split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split_)
    return load_docs


_GEN = {"max_new_tokens": 8, "temperature": 0, "do_sample": False}

for _name, _hub, _split in (
        ("mmt_val", "lmms-lab/MMT-Benchmark", "val"),
        ("mmt_test", "lmms-lab/MMT-Benchmark", "test"),
        ("mmt_mi_val", "lmms-lab/MMT_MI-Benchmark", "val"),
        ("mmt_mi_test", "lmms-lab/MMT_MI-Benchmark", "test")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answer"),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="mmt_accuracy",
        load_docs=_make_load(_hub, _split),
        doc_id_key="index",
        generation_kwargs=dict(_GEN),
    ))
