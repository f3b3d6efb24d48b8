"""MMMU-Pro (parity: lmms_eval/tasks/mmmu_pro/utils.py + the 6 task
yamls + _default_template_yaml + mmmu_pro.yaml / mmmu_pro_cot.yaml).

Three MMMU/MMMU_Pro configs, each with a direct and a CoT variant:

* ``mmmu_pro_standard`` ("standard (10 options)") and
  ``mmmu_pro_standard_cot`` ("standard"): classic prompt build —
  question + lettered options + per-yaml post_prompt
  (utils.py:35-56); answers parsed with the official MMMU
  parse_multi_choice_response (reused from tasks/mmmu.py, where the
  random no-parse fallback is a deterministic crc32 draw).
* ``mmmu_pro_vision`` / ``mmmu_pro_vision_cot``: the question is baked
  into the image; doc_to_text is the yaml's fixed instruction and the
  raw response is compared to the gold letter EXACTLY, with no parsing
  (utils.py:72-79 falls to parsed_pred = pred for docs without
  question/options — preserved bug-for-bug; CoT responses therefore
  need the model to answer with the bare letter).
* ``mmmu_pro_composite`` / ``_cot``: several questions per image;
  golds are a list; prediction letters are re.findall(r"\\b[A-Z]\\b")
  cut/padded to the gold count and scored element-wise
  (utils.py:85-100).

Aggregation (utils.py:103-140): per-subject accuracy -> instruction-
level domain rollups (DOMAIN_CAT2SUB_CAT) -> overall instruction-level
accuracy, all round(.., 5); composite list records contribute one
count per sub-question. Groups: ``mmmu_pro`` = vision + standard (the
reference drops composite from the formal eval, mmmu_pro.yaml:4) and
``mmmu_pro_cot`` = the three CoT arms. DIVERGENCE: the reference's
mmmu_pro_cot.yaml:5 lists "mmmu_pro_original_cot", a task defined
nowhere in its tree (grep confirms the yaml is its only occurrence —
the group is broken upstream); this port substitutes the evidently
intended standard-config CoT arm, mmmu_pro_standard_cot.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.mmmu import (
    DOMAIN_CAT2SUB_CAT,
    _options_list,
    eval_multi_choice,
    get_multi_choice_info,
    parse_multi_choice_response,
)

# per-yaml prompts (doc_to_text strings / post_prompt kwargs)
STANDARD_POST = "Answer with the option letter from the given choices directly."
STANDARD_COT_POST = (
    "Answer the following multiple choice question. The last line of your "
    "response should be of the following format: 'Answer: $LETTER' "
    "(without quotes) where LETTER is one of options. Think step by step "
    "before answering.")
VISION_PROMPT = "Answer with the option letter from the given choices directly."
VISION_COT_PROMPT = (
    "Write out the multiple-choice question in the image and then solve "
    "it. The last line of your response should be of the following "
    "format: 'Answer: $LETTER' (without quotes) where LETTER is one of "
    "options. Think step by step before answering.")
COMPOSITE_PROMPT = (
    "Answer with the option letter for each multiple choice question "
    "from the given choices directly. For each question, the last line "
    "of your response should be in the following format: 'No: [id]\n"
    "Answer: [LETTER]' (without quotes) where LETTER is one of options.")
COMPOSITE_COT_PROMPT = (
    "Write out all the multiple-choice questions in the image and then "
    "solve it. For each question, the last line of your response should "
    "be in the following format: 'No: [id]\nAnswer: [LETTER]' (without "
    "quotes) where LETTER is one of options. Think step by step before "
    "answering each question.")


def construct_prompt(doc, post_prompt: str = STANDARD_POST) -> str:
    """utils.py:35-47 (interleaved_format: false keeps <image N>)."""
    options = _options_list(doc)
    letters = [chr(ord("A") + i) for i in range(len(options))]
    block = "\n".join(f"{l}. {o}" for l, o in zip(letters, options))
    return f"{doc['question']}\n{block}\n\n{post_prompt}"


def _resolve(doc, field: str, data_root: str):
    import os

    p = doc[field]
    if hasattr(p, "convert"):
        return p
    p = os.path.join(data_root, p) if data_root else p
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:59-69: standard docs expose the sorted unique <image N>
    slots the prompt references; vision/composite docs carry one
    'image' field."""
    if "question" in doc and "options" in doc:
        prompt = construct_prompt(doc)
        tokens = sorted({t.strip("<>").replace(" ", "_")
                         for t in re.findall(r"<image \d+>", prompt)})
        return [_resolve(doc, t, data_root) for t in tokens]
    return _resolve(doc, "image", data_root)


def _make_doc_to_text(post_prompt: str):
    def doc_to_text(doc, post_prompt: str = post_prompt) -> str:
        return construct_prompt(doc, post_prompt)
    return doc_to_text


def process_results(doc, response: str) -> dict:
    """utils.py:72-79 — parse only when the doc carries the options."""
    if "question" in doc and "options" in doc:
        index2ans, all_choices = get_multi_choice_info(_options_list(doc))
        parsed = parse_multi_choice_response(response, all_choices,
                                             index2ans, doc_id=str(doc["id"]))
    else:
        parsed = response
    return {"id": doc["id"], "subject": doc["subject"],
            "answer": doc["answer"], "parsed_pred": parsed}


def process_results_composite(doc, response: str) -> dict:
    """utils.py:85-100."""
    import ast

    answers = doc["answers"]
    gt_list = (ast.literal_eval(answers) if isinstance(answers, str)
               else list(answers))
    letters = re.findall(r"\b[A-Z]\b", response)[:len(gt_list)]
    letters += [""] * (len(gt_list) - len(letters))
    return {"id": doc["id"], "subject": doc["subject"],
            "answer": gt_list, "parsed_pred": letters}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:103-140 + evaluate_mmmu: instruction-level accs."""
    by_sub: Dict[str, list] = defaultdict(list)
    for r in records:
        if isinstance(r["answer"], list):
            by_sub[r["subject"]].extend(
                float(eval_multi_choice(g, p))
                for g, p in zip(r["answer"], r["parsed_pred"]))
        else:
            by_sub[r["subject"]].append(
                float(eval_multi_choice(r["answer"], r["parsed_pred"])))
    if not by_sub:
        return {"mmmu_pro_acc": 0.0}
    sub_acc = {s: sum(v) / len(v) for s, v in by_sub.items()}
    sub_num = {s: len(v) for s, v in by_sub.items()}

    def ins_level(subs):
        n = sum(sub_num[s] for s in subs)
        return (sum(sub_acc[s] * sub_num[s] for s in subs) / n) if n else 0.0

    out = {"mmmu_pro_acc": round(ins_level(list(sub_acc)), 5)}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        present = [c for c in cats if c in sub_acc]
        if present:
            out[f"mmmu_pro_{domain}"] = round(ins_level(present), 5)
    for s in sorted(sub_acc):
        out[f"mmmu_pro_{s}"] = round(sub_acc[s], 5)
    return out


def _make_load_docs(config: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("MMMU/MMMU_Pro", data_root, split,
                                   subset=config)
    return load_docs


_GEN = {"max_new_tokens": 256}  # _default_template_yaml

_TASKS = (
    # (name, config, doc_to_text, process_results)
    ("mmmu_pro_standard", "standard (10 options)",
     _make_doc_to_text(STANDARD_POST), process_results),
    ("mmmu_pro_standard_cot", "standard",
     _make_doc_to_text(STANDARD_COT_POST), process_results),
    ("mmmu_pro_vision", "vision",
     lambda doc: VISION_PROMPT, process_results),
    ("mmmu_pro_vision_cot", "vision",
     lambda doc: VISION_COT_PROMPT, process_results),
    ("mmmu_pro_composite", "composite",
     lambda doc: COMPOSITE_PROMPT, process_results_composite),
    ("mmmu_pro_composite_cot", "composite",
     lambda doc: COMPOSITE_COT_PROMPT, process_results_composite),
)

for _name, _config, _text, _proc in _TASKS:
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_text,
        doc_to_target=lambda doc: doc.get("answer", doc.get("answers")),
        process_results=_proc,
        aggregate=aggregate,
        primary_metric="mmmu_pro_acc",
        load_docs=_make_load_docs(_config),
        generation_kwargs=dict(_GEN),
    ))
