"""MME-RealWorld en/cn/lite (parity: lmms_eval/tasks/mme_realworld/
utils.py + the 3 yamls).

5-way MCQ (A-E, E is usually "cannot decide") over high-resolution
real-world imagery: ``mmerealworld`` (yifanzhang114/MME-RealWorld-
Lmms-eval), ``mmerealworld_cn`` (…-CN-…), ``mmerealworld_lite``
(…-lite-…), each test_split "train". Docs carry index / question /
"multi-choice options" (rendered "(A) …" lines) / answer (letter) /
category ("Perception/..." or "Reasoning/...") / l2-category / bytes
(base64 image).

Parity:
* doc_to_text (utils.py:52-59, cn :66-73): question + "The choices are
  listed below:\\n" + option lines + the fixed English (or Chinese)
  letter-only instruction ending "The best answer is: ".
* extract_characters_regex (utils.py:94-123): strip the 8 known answer
  prefixes, bail to "" for >10-word responses with no A-E, else the
  FIRST A-E hit; as a last resort map an option-text response to its
  letter by containment.
* scoring (utils.py:173-231): hit = pred.lower() == answer.lower() OR
  answer.lower() in pred.lower(); rollups per Task (Perception/
  Reasoning), per subtask, and per l2-category (an "attribute"
  l2-category collapses to "<head>/attribute"); overall = micro
  accuracy. E-choice counts are recoverable from samples.jsonl.
* visuals: docs carry base64 bytes (utils.py:31-49) — decoded to a PIL
  image; local fixtures may use an "image" path field instead.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

EN_INSTR = ("Select the best answer to the above multiple-choice question "
            "based on the image. Respond with only the letter (A, B, C, D, "
            "or E) of the correct option.\nThe best answer is: ")
CN_INSTR = ("根据图像选择上述多项选择题的最佳答案。只需回答正确选项的字母"
            "（A, B, C, D 或 E）。\n最佳答案为： ")

ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option is",
    "The correct option is",
    "Best answer:",
    "Best option:",
]


def extract_characters_regex(s, choices=("(A)", "(B)", "(C)", "(D)",
                                         "(E)")) -> str:
    """utils.py:94-123."""
    if isinstance(s, dict):
        s = ""
    s = s.strip()
    for prefix in ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCDE]", s):
        return ""
    m = re.search(r"[ABCDE]", s)
    if m is None:
        for choice in choices:
            if s.lower() in choice.lower():
                return choice[1]
        return ""
    return m[0]


def _make_doc_to_text(instr: str, zh: bool):
    def doc_to_text(doc) -> str:
        opts = "\n".join(doc["multi-choice options"])
        head = "选项如下所示:\n" if zh else "The choices are listed below:\n"
        sep = " "
        return f"{doc['question']}{sep}{head}{opts}\n{instr}"
    return doc_to_text


def doc_to_visual(doc, data_root: str = ""):
    import os

    if doc.get("bytes"):
        import base64
        import io

        from PIL import Image

        image = Image.open(io.BytesIO(base64.b64decode(doc["bytes"])))
        if image.mode in ("RGBA", "P"):
            image = image.convert("RGB")
        return image
    p = doc["image"]
    p = os.path.join(data_root, p) if data_root else p
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    category = ("Perception" if "perception" in doc["category"].lower()
                else "Reasoning")
    return {
        "question_id": doc["index"],
        "category": category,
        "sub_category": doc["category"].split("/")[-1],
        "task_category": doc["l2-category"],
        "pred_answer": extract_characters_regex(response),
        "answer": doc["answer"],
        "is_E": extract_characters_regex(response) == "E",
    }


def _hit(r: dict) -> bool:
    """utils.py:190: equality OR gold-in-pred containment."""
    p, a = r["pred_answer"].lower(), r["answer"].lower()
    return p == a or a in p


def _l2(r: dict) -> str:
    cat = r["task_category"].lower()
    if "attribute" in cat:
        cat = cat.split("/")[0] + "/attribute"
    return cat


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"mme_realworld_score": 0.0}
    out = {"mme_realworld_score":
           sum(_hit(r) for r in records) / len(records)}
    for key, fn in (("task", lambda r: r["category"]),
                    ("subtask", lambda r: r["sub_category"]),
                    ("l2", _l2)):
        groups: Dict[str, list] = {}
        for r in records:
            groups.setdefault(fn(r), []).append(float(_hit(r)))
        for g, v in sorted(groups.items()):
            slug = re.sub(r"\W+", "_", g.lower()).strip("_")
            out[f"mme_realworld_{key}_{slug}"] = sum(v) / len(v)
    return out


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "train") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 16, "temperature": 0, "do_sample": False}

for _name, _hub, _zh in (
        ("mmerealworld", "yifanzhang114/MME-RealWorld-Lmms-eval", False),
        ("mmerealworld_cn", "yifanzhang114/MME-RealWorld-CN-Lmms-eval",
         True),
        ("mmerealworld_lite", "yifanzhang114/MME-RealWorld-lite-lmms-eval",
         False)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_make_doc_to_text(CN_INSTR if _zh else EN_INSTR, _zh),
        doc_to_target=lambda doc: doc["answer"],
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="mme_realworld_score",
        load_docs=_make_load(_hub),
        doc_id_key="index",
        generation_kwargs=dict(_GEN),
    ))
