"""WorldQA world-knowledge video QA — the two judge-free variants.

Parity: lmms_eval/tasks/worldqa/ — docs carry video_idx / question /
option (["A. text", ...]) / answer ("A. text") / question_idx /
object_description.

* worldqa_mc (worldqa_mc.yaml): generate; the reference first applies its
  custom MultiChoiceRegexFilter (utils.py:237-298: strip punctuation,
  map a contained choice text back to its letter, else keep the cleaned
  response), then scores with WorldQA_MC_Evaluator.evaluate
  (worldqa_mc_evaluator.py:106-114): rule-based letter inference
  (can_infer_option, num_choice=4) with a GPT matcher as fallback. The
  fallback is an external-API dependency this rebuild replaces with
  rating 0 + match_success=False in the record.
* worldqa_mc_ppl (worldqa_mcppl.yaml): the reference's multiple_choice
  output type — per-option loglikelihood over the bare question
  (doc_to_text: "question"), option text from op.split(".")[1]
  (utils.py:164-166, 233-234), argmax -> acc. Built on the shared
  make_mc_ll_suite machinery (adds acc_norm alongside).

The generation + GPT-scored worldqa_gen variant is judge-only and is not
ported.
"""

from __future__ import annotations

import os
import re
import string
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.mc_loglikelihood import make_mc_ll_suite

POST_PROMPT = "\nAnswer with the option's letter from the given choices directly."


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "videos") if data_root else "videos"
    for ext in (".mp4", ".MP4"):
        path = os.path.join(base, str(doc["video_idx"]) + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(base, str(doc["video_idx"]) + ".mp4"))


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = POST_PROMPT):
    question = doc["question"]
    for op in doc.get("option", []):
        question += "\n" + op
    return f"{pre_prompt}{question}{post_prompt}"


def filter_response(doc, response: str) -> str:
    """The reference's custom MultiChoiceRegexFilter (utils.py:250-298):
    punctuation-stripped response; a contained choice text maps back to
    its letter, else the cleaned response passes through."""
    question = doc["question"]
    for op in doc.get("option", []):
        question += "\n" + op
    choice_to_alpha = {}
    next_alpha = "A"
    for _letter, text in re.findall(r"\b([A-Z])\.\s+([^\n]*)", question):
        choice_to_alpha[text.strip()] = next_alpha
        next_alpha = chr(ord(next_alpha) + 1)
    cleaned = re.sub(r"[^\w\s]", "", response).strip()
    if choice_to_alpha:
        pat = re.compile("|".join(re.escape(t) for t in choice_to_alpha))
        m = pat.search(cleaned)
        if m and m.group() in choice_to_alpha:
            return choice_to_alpha[m.group()]
    return cleaned


def can_infer_option(answer: str, num_choice: int = 4):
    """Rule-based letter inference (worldqa_mc_evaluator.py:44-71),
    including the 'A might be a quantifier' guard."""
    choices = string.ascii_uppercase[:num_choice]

    def count(splits, prefix="", suffix=""):
        return sum(1 for c in choices if prefix + c + suffix in splits)

    splits = [x.strip() for x in answer.split()]
    if count(splits) == 1:
        for ch in choices:
            if "A" in splits and len(splits) > 3:
                break  # 'A' is likely the article, not the option
            if ch in splits:
                return ch
    for pre, suf in (("", "."), ("", ","), ("", ":"), ("", ")"), ("", ")."),
                     ("(", ")"), ("(", ")."), (":", ""), (":", ","),
                     (":", "."), (":", ")"), (":", ").")):
        if count(splits, pre, suf) == 1:
            for ch in choices:
                if pre + ch + suf in splits:
                    return ch
    return False


def process_results_mc(doc, response: str) -> dict:
    pred = filter_response(doc, response if isinstance(response, str) else "")
    answer_letter = doc["answer"].split(".")[0].strip()
    inferred = can_infer_option(pred, num_choice=4)
    if inferred:
        rating = int(inferred.lower().strip() == answer_letter.lower())
        match_success = True
    else:
        rating = 0  # reference would ask the GPT matcher here
        match_success = False
    return {
        "pred": pred,
        "question_idx": doc["question_idx"],
        "object_description": doc.get("object_description", ""),
        "answer": doc["answer"],
        "option": doc.get("option", []),
        "question": doc["question"],
        "rating": rating,
        "match_success": match_success,
    }


def aggregate_mc(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"worldqa_mc_accuracy": 0.0}
    return {
        "worldqa_mc_accuracy":
            sum(r["rating"] for r in records) / len(records),
        "worldqa_mc_match_rate":
            sum(r["match_success"] for r in records) / len(records),
    }


def _load(subset):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/worldqa", data_root, split,
                                   subset=subset)

    return load_docs


register_task(Task(
    name="worldqa_mc",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results_mc,
    aggregate=aggregate_mc,
    load_docs=_load("MC"),
    doc_id_key=None,
    primary_metric="worldqa_mc_accuracy",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))


# ---- mc_ppl: per-option loglikelihood ----------------------------------

def _answer_index(doc) -> int:
    return ord(doc["answer"].split(".")[0].strip().upper()) - ord("A")


_expand, _ll_target, _ll_process, _ll_aggregate = make_mc_ll_suite(
    qid_of=lambda d: d["question_idx"],
    n_options_of=lambda d: len(d["option"]),
    option_text_of=lambda d, i: d["option"][i].split(".")[1].strip(),
    answer_index_of=_answer_index,
    metric_prefix="worldqa_mc_ppl",
)


def _ll_load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return _expand(load_benchmark_docs("lmms-lab/worldqa", data_root,
                                       split, subset="MC_PPL"))


register_task(Task(
    name="worldqa_mc_ppl",
    doc_to_visual=doc_to_visual,
    # reference worldqa_mcppl.yaml doc_to_text: "question" (bare field)
    doc_to_text=lambda doc: doc["question"],
    process_results=_ll_process,
    aggregate=_ll_aggregate,
    load_docs=_ll_load,
    doc_id_key="_ll_id",
    primary_metric="worldqa_mc_ppl_acc",
    output_type="loglikelihood",
    doc_to_target=_ll_target,
))

register_group("worldqa", ["worldqa_mc", "worldqa_mc_ppl"])
