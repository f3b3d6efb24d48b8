"""JMMMU (parity: lmms_eval/tasks/jmmmu/utils.py +
_default_template_yaml + the 28 per-subject yamls; group jmmmu.yaml).

Japanese MMMU over JMMMU/JMMMU (one dataset config per subject, split
test). 28 tasks ``jmmmu_<subject>``: 24 culture-agnostic subjects
(translated MMMU) + 4 culture-specific (Japanese_Art,
Japanese_Heritage, Japanese_History, World_History).

Parity:
* construct_prompt (utils.py:45-62): "<image1>" typo normalized to
  "<image 1>", then question + "A. x" options + the Japanese
  MULTI_CHOICE_PROMPT, or + OPEN_ENDED_PROMPT for open questions;
  interleaved_format: false keeps the <image N> tokens.
* visuals: sorted unique <image N> slots (utils.py:65-72).
* answers: the official MMMU parse_multi_choice_response (reused from
  tasks/mmmu.py, crc32 no-parse fallback) for MCQ;
  parse_open_response with JAPANESE sentence splitting
  ([。！？.]\\s*|\\n) and indicators (よって/答えは/解答は/最終的に/＝,
  utils.py:393-456) for open questions — note the reference's missing
  comma makes "解答は、回答は" ONE concatenated indicator (implicit
  string concat, utils.py:406); preserved bug-for-bug.
* aggregation (utils.py:102-137): per-subject accs -> the JMMMU
  5-domain instruction-level rollups -> overall (round 5). The
  jmmmu group averages all 28; culture_agnostic / culture_specific
  subgroups mirror the yaml tags (size-weighted via the group-rollup
  convention).
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.mmmu import (
    _options_list,
    eval_multi_choice,
    eval_open,
    extract_numbers,
    get_multi_choice_info,
    normalize_str,
    parse_multi_choice_response,
)

MULTI_CHOICE_PROMPT = "与えられた選択肢の中から最も適切な回答のアルファベットを直接記入してください。"
OPEN_ENDED_PROMPT = "質問に対する回答を単語や短いフレーズで記入してください。"

CULTURE_SPECIFIC = ("Japanese_Art", "Japanese_Heritage",
                    "Japanese_History", "World_History")
CULTURE_AGNOSTIC = (
    "Accounting", "Agriculture", "Architecture_and_Engineering",
    "Basic_Medical_Science", "Biology", "Chemistry", "Clinical_Medicine",
    "Computer_Science", "Design", "Diagnostics_and_Laboratory_Medicine",
    "Economics", "Electronics", "Energy_and_Power", "Finance", "Manage",
    "Marketing", "Materials", "Math", "Mechanical_Engineering", "Music",
    "Pharmacy", "Physics", "Psychology", "Public_Health")

DOMAIN_CAT2SUB_CAT = {
    "Art and Psychology": ["Design", "Music", "Psychology"],
    "Business": ["Accounting", "Economics", "Finance", "Manage",
                 "Marketing"],
    "Science": ["Biology", "Chemistry", "Math", "Physics"],
    "Health and Medicine": ["Basic_Medical_Science", "Clinical_Medicine",
                            "Diagnostics_and_Laboratory_Medicine",
                            "Pharmacy", "Public_Health"],
    "Tech and Engineering": ["Agriculture", "Architecture_and_Engineering",
                             "Computer_Science", "Electronics",
                             "Energy_and_Power", "Materials",
                             "Mechanical_Engineering"],
    # the 4 culture-specific subjects sit outside the MMMU domains and
    # only roll into Overall + the culture_specific group
}

# utils.py:406 — the missing comma concatenates two indicators; kept.
_JA_INDICATORS = ["よって", "よって、", "答えは", "答えは、", "最終的に",
                  "最終的に、", "解答は", "解答は、" "回答は", "回答は、"]
_TRIVIAL = {",", ".", "!", "?", ";", ":", "'", "、", "。", "！", "？",
            "；", "："}


def parse_open_response_ja(response: str) -> list:
    """utils.py:393-456."""
    def get_key_subresponses(resp: str) -> List[str]:
        resp = resp.strip().strip("。")
        subs = re.split(r"[。！？.]\s*|\n", resp)
        out = []
        for i, sub in enumerate(subs):
            inds = list(_JA_INDICATORS)
            if i == len(subs) - 1:
                inds.extend(["＝", "="])
            shortest = None
            for ind in inds:
                if ind in sub:
                    tail = sub.split(ind)[-1].strip()
                    if shortest is None or len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in _TRIVIAL:
                out.append(shortest)
        return out or [resp]

    keys = get_key_subresponses(response)
    pred_list = list(keys)
    for r in keys:
        pred_list.extend(extract_numbers(r))
    out = []
    for p in pred_list:
        out.extend(normalize_str(p))
    return list(set(out))


def construct_prompt(doc) -> str:
    question = doc["question"].replace("<image1>", "<image 1>")
    if doc["question_type"] == "multiple-choice":
        options = _options_list(doc)
        letters = [chr(ord("A") + i) for i in range(len(options))]
        block = "\n".join(f"{l}. {o}" for l, o in zip(letters, options))
        return f"{question}\n{block}\n\n{MULTI_CHOICE_PROMPT}"
    return f"{question}\n\n{OPEN_ENDED_PROMPT}"


def doc_to_text(doc) -> str:
    return construct_prompt(doc)


def doc_to_visual(doc, data_root: str = ""):
    import os

    prompt = construct_prompt(doc)
    tokens = sorted({t.strip("<>").replace(" ", "_")
                     for t in re.findall(r"<image \d+>", prompt)})
    out = []
    for t in tokens:
        v = doc[t]
        if hasattr(v, "convert"):
            out.append(v)
            continue
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def _make_process_results(subject: str):
    def process_results(doc, response: str) -> dict:
        if doc["question_type"] == "multiple-choice":
            index2ans, all_choices = get_multi_choice_info(
                _options_list(doc))
            parsed = parse_multi_choice_response(response, all_choices,
                                                 index2ans,
                                                 doc_id=str(doc["id"]))
        else:
            parsed = parse_open_response_ja(response)
        return {"id": doc["id"], "subdomain": subject,
                "question_type": doc["question_type"],
                "answer": doc["answer"], "parsed_pred": parsed}
    return process_results


def _is_correct(r: dict) -> bool:
    if r["question_type"] == "multiple-choice":
        return eval_multi_choice(r["answer"], r["parsed_pred"])
    return eval_open(r["answer"], r["parsed_pred"])


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"jmmmu_acc": 0.0}
    by_sub: Dict[str, list] = {}
    for r in records:
        by_sub.setdefault(r["subdomain"], []).append(
            float(_is_correct(r)))
    total = sum(len(v) for v in by_sub.values())
    out = {"jmmmu_acc":
           round(sum(sum(v) for v in by_sub.values()) / total, 5)}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        present = [by_sub[c] for c in cats if c in by_sub]
        if present:
            n = sum(len(v) for v in present)
            out[f"jmmmu_{domain}"] = round(
                sum(sum(v) for v in present) / n, 5)
    for s in sorted(by_sub):
        out[f"jmmmu_{s}"] = round(sum(by_sub[s]) / len(by_sub[s]), 5)
    return out


def _make_load(config: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("JMMMU/JMMMU", data_root, split,
                                   subset=config)
    return load_docs


for _subject in CULTURE_AGNOSTIC + CULTURE_SPECIFIC:
    register_task(Task(
        name=f"jmmmu_{_subject.lower()}",
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answer"),
        process_results=_make_process_results(_subject),
        aggregate=aggregate,
        primary_metric="jmmmu_acc",
        load_docs=_make_load(_subject),
        generation_kwargs={"max_new_tokens": 1024},
    ))
