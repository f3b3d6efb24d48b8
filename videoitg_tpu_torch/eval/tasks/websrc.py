"""WebSRC (parity: lmms_eval/tasks/websrc/utils.py +
websrc_{val,test}.yaml; group websrc.yaml).

Web-screenshot structural reading comprehension over
rootsautomation/websrc: ``websrc_val`` (split dev) and ``websrc_test``
(split test, answers withheld — submission-only). Docs carry id /
page_id / domain / question / answer / image (base64).

Parity:
* doc_to_text (utils.py:17-24): the OPEN_ENDED_PROMPT comes FIRST —
  "Answer the question using a single word or phrase.\\n{question}".
* visuals: base64-decoded screenshot (utils.py:27-31).
* scoring (utils.py:118-160): token-set F1 per sample — normalize
  (lower+strip), tokenize words and isolated punctuation
  (r"\\w+|[^\\w\\s]"), set precision/recall/F1; rollups per domain
  (the 11 DOMAINS), overall = example-weighted mean over domains
  (equals the plain mean).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

OPEN_ENDED_PROMPT = "Answer the question using a single word or phrase."

DOMAINS = ("auto", "book", "camera", "game", "jobs", "movie", "phone",
           "restaurant", "sports", "university", "hotel")

_TOKEN_RE = re.compile(r"\w+|[^\w\s]")


def compute_f1(gold: str, pred: str) -> float:
    """utils.py:133-151 — token-SET F1."""
    sa = set(_TOKEN_RE.findall(gold.lower().strip()))
    sb = set(_TOKEN_RE.findall(pred.lower().strip()))
    if not sa or not sb:
        return 0.0
    comm = sa & sb
    prec, rec = len(comm) / len(sb), len(comm) / len(sa)
    return 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0


def doc_to_text(doc) -> str:
    return f"{OPEN_ENDED_PROMPT}\n{doc['question']}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    if isinstance(img, str) and not os.path.exists(
            os.path.join(data_root, img) if data_root else img):
        import base64
        import io

        from PIL import Image

        return Image.open(io.BytesIO(base64.b64decode(img)))
    p = os.path.join(data_root, img) if data_root else img
    return p


def process_results(doc, response: str) -> dict:
    out = {"id": doc["page_id"], "domain": doc["domain"],
           "parsed_pred": response}
    if "answer" in doc and doc["answer"] is not None:
        out["answer"] = doc["answer"]
        out["f1"] = compute_f1(doc["answer"], response)
    if "id" in doc:
        out["question_id"] = doc["id"]
    return out


def aggregate(records: List[dict]) -> Dict[str, float]:
    scored = [r for r in records if "f1" in r]
    if not scored:
        return {"websrc_squad_f1": 0.0}
    by_domain: Dict[str, list] = defaultdict(list)
    for r in scored:
        by_domain[r["domain"]].append(r["f1"])
    out = {"websrc_squad_f1":
           round(sum(r["f1"] for r in scored) / len(scored), 3)}
    for d, v in sorted(by_domain.items()):
        out[f"websrc_f1_{d}"] = round(sum(v) / len(v), 3)
    return out


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("rootsautomation/websrc", data_root,
                                   split_)
    return load_docs


_GEN = {"max_new_tokens": 32, "temperature": 0, "do_sample": False}

register_task(Task(
    name="websrc_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="websrc_squad_f1",
    load_docs=_make_load("dev"),
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="websrc_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=lambda rs: {"submission_rows": float(len(rs))},
    load_docs=_make_load("test"),
    generation_kwargs=dict(_GEN),
))
