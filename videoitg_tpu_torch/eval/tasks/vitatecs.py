"""VITATECS temporal-concept caption-matching tasks (6 aspects).

Parity: lmms_eval/tasks/vitatecs/ — docs carry caption / counterfactual /
src_dataset / video_name / aspect. Each doc becomes a 2-way caption
matching question whose A/B order is a deterministic function of the text
(utils.py:92-105: ``random.seed(sum(ord(c) for c in caption +
counterfactual) % 100)`` then one ``random.random() > 0.5`` draw), so the
shuffle reproduces the reference exactly. Prompt = question + the
_default_template_yaml post_prompt. Scoring is the reference's
hand-crafted matching (utils.py:119-133): option-text containment first,
then bare letter / "A." / "A)" / "(A)" prefixes. The reference falls back
to a ChatGPT judge when every rule fails (utils.py:134-140) — an
external-API dependency this rebuild replaces with rating 0 +
match_success=False in the record (the unmatched rate is visible in the
aggregate; no scoring difference when rules match). Metric:
accuracy * 100 (utils.py:215-225).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

POST_PROMPT = "\nPlease response with a single letter (A or B):"

ASPECTS = ("Direction", "Intensity", "Sequence", "Compositionality",
           "Localization", "Type")


def doc_to_visual(doc, data_root: str = ""):
    """Reference cache layout: <cache_dir>/<src_dataset>/<video_name>
    (utils.py:57-62); an aspect subdirectory (the loader's per-subset
    layout) is also honoured."""
    rel = os.path.join(doc.get("src_dataset", ""), doc["video_name"])
    for path in (os.path.join(data_root, doc.get("aspect", ""), rel),
                 os.path.join(data_root, rel)):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(data_root, rel))


def _option_for_question(sent: str) -> str:
    if not sent.endswith("."):
        sent += "."
    return sent.capitalize()


def _option_for_matching(sent: str) -> str:
    return sent[:-1].lower() if sent.endswith(".") else sent.lower()


def format_question_and_answer(doc):
    """Deterministic A/B shuffle; reference utils.py:92-105."""
    seed = sum(ord(c) for c in doc["caption"] + doc["counterfactual"]) % 100
    rng = random.Random(seed)
    if rng.random() > 0.5:
        option_a = _option_for_question(doc["caption"])
        option_b = _option_for_question(doc["counterfactual"])
        answer = "(A) " + option_a
    else:
        option_a = _option_for_question(doc["counterfactual"])
        option_b = _option_for_question(doc["caption"])
        answer = "(B) " + option_b
    options = [_option_for_matching(doc["caption"]),
               _option_for_matching(doc["counterfactual"])]
    question = ("Which of the following best describes the content of the "
                f"video: \n(A) {option_a} \n(B) {option_b}")
    return question, answer, options


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = POST_PROMPT):
    question, _, _ = format_question_and_answer(doc)
    return f"{pre_prompt}{question}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response.strip() if isinstance(response, str) else response
    question, answer, options = format_question_and_answer(doc)
    rating = 0
    match_success = True
    low = pred.lower()
    if options[0] in low and options[1] not in low:
        rating = 1
    elif options[1] in low and options[0] not in low:
        rating = 0
    elif pred in ("A", "B"):
        rating = int(pred == answer[1])
    elif any(pred.startswith(p) for p in ("A.", "B.")):
        rating = int(pred.split(".")[0] == answer[1])
    elif any(pred.startswith(p) for p in ("A)", "B)")):
        rating = int(pred.split(")")[0] == answer[1])
    elif any(pred.startswith(p) for p in ("(A)", "(B)")):
        # Reference quirk (utils.py:131-132): compares the text AFTER the
        # paren to the answer letter, so "(B) since" rates 0 yet counts as
        # rule-matched. Reproduced as-is for score parity.
        rating = int(pred.split(")")[1] == answer[1])
    else:
        match_success = False  # reference would call the ChatGPT judge here
    return {
        "src_dataset": doc.get("src_dataset", ""),
        "video_id": doc["video_name"],
        "question": question,
        "gt-answer": answer,
        "video-llm-prediction": pred,
        "match_success": match_success,
        "rating": rating,
        "aspect": doc.get("aspect", ""),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"vitatecs_accuracy": 0.0}
    acc = 100.0 * sum(r["rating"] for r in records) / len(records)
    match = 100.0 * sum(r["match_success"] for r in records) / len(records)
    return {"vitatecs_accuracy": acc, "vitatecs_match_rate": match}


def _load(aspect):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lscpku/VITATECS", data_root, split,
                                   subset=aspect)

    return load_docs


for _aspect in ASPECTS:
    register_task(Task(
        name=f"vitatecs_{_aspect.lower()}",
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results,
        aggregate=aggregate,
        load_docs=_load(_aspect),
        doc_id_key=None,
        primary_metric="vitatecs_accuracy",
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
    ))

register_group("vitatecs", [f"vitatecs_{a.lower()}" for a in ASPECTS])
