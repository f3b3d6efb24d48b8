"""MixEval-X video2text: multiple-choice + free-form (and _hard splits).

Parity: lmms_eval/tasks/mix_evals/video2text/ over MixEval/MixEval-X
(dataset_name video2text; splits multiple_choice / free_form and their
_hard variants). Docs carry input_file (list of video paths), query,
options (mc) and reference_answer.

* Prompt (utils.py:183-215): pre_prompt \\n query [\\n "Here are the
  options:" + lettered options] \\n post_prompt; per-model gpt4v
  overrides via Task.prompt_overrides.
* mc: the model's free text goes through the gpt_mc_extract filter
  (option letter via judge, emitted as index string, utils.py:351-422)
  and is exact-matched (ignore_case + ignore_punctuation) against
  reference_answer (mix_evals_video2text_mc.yaml:13-23).
* freeform: the judge scores 0.0-1.0 in "[[score]]" format against the
  bracketed golden-answer list (utils.py:49-101,264-276); aggregation is
  the mean. DIVERGENCE: the reference substitutes round(random(), 1)
  when no score parses (utils.py:100) — here an unparseable judge reply
  deterministically scores 0.0.
* openended is submission-only and commented out of the reference's own
  group (mix_evals_video2text.yaml:4); not ported.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.metrics import exact_match

PRE_PROMPT = ("These are frames from a video. Please answer the following "
              "questions about the video.")
MC_POST_PROMPT = ("Answer with the option's letter from the given choices "
                  "directly.")
FREEFORM_HARD_POST_PROMPT = "Answer the question using a single word or phrase."

FREEFORM_SYSTEM = "In this task, I want you to act as a judge."

# Verbatim reference judge template (utils.py:49-84), including examples.
FREEFORM_USER_TEMPLATE = """You will be provided with a question, its golden answer(s), and the model's answer, while the context of the question, which is one or more videos, is not given here. Your task is to judge how correct the model's answer is based on the golden answer(s), without seeing the input videos of the question, and then give a correctness score. The correctness score should be one of the below numbers: 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Your should first briefly give your reasoning process regarding how the model's answer conforms to or contradicts the golden answer(s), and then give the correctness score. The correctness score must strictly follow this format: \"[[score]]\", e.g., \"The correctness score: [[0.5]]\". Below are some examples.

Example 1:
Question: what does this video want to express
Golden Answer(s): <answer 1> introduce method of playing
Model's Answer: Volleyball serve \n
Your Judgment: The model's answer "Volleyball serve" suggests a specific action, which may be part of what the video demonstrates. However, it misses the broader educational intent implied by the golden answer "introduce method of playing". Therefore, the answer is partially correct. The Correctness Score: [[0.5]]

Example 2:
Question: who do two other boys with surprised looks assist up?
Golden Answer(s): <answer 1> boy
Model's Answer: Boy.
Your Judgment: The model's answer "Boy." precisely matches the golden answer which states the two other boys assist a "boy". The Correctness Score: [[1.0]]

Example 3:
Question: what did the lady do at the end of the video after their performance
Golden Answer(s): <answer 1> picks up her phone
Model's Answer: Nothing.
Your Judgment: The model's answer "Nothing." directly contradicts the golden answer which states that the lady "picks up her phone" at the end of the video after their performance. Since the model's response completely misses the specific action described in the golden answer, it is incorrect. The Correctness Score: [[0.0]]

Note that each one of the golden answers is considered correct. Thus if the model's answer matches any one of the golden answers, it should be considered correct. Judge the below case, give the brief reasoning process and the correctness score.

Question: {prompt}
Golden Answer(s): {gold_ans}
Model's Answer: {response}
Your Judgment:
"""
# Byte-parity with the reference f-string (utils.py:53-79): it carries
# trailing spaces editors would silently strip from a literal here.
FREEFORM_USER_TEMPLATE = FREEFORM_USER_TEMPLATE.replace(
    "Below are some examples.\n", "Below are some examples. \n").replace(
    "Your Judgment:\n", "Your Judgment: \n")

MC_SYSTEM = "In this task, I want you to act as an option extractor."

# Verbatim reference extractor template (utils.py:300-349).
MC_USER_TEMPLATE = """You will be provided with a multiple-choice question, its options, and the model's answer, while the context of the question, which is one or more videos, is not given here. Your task is to extract or judge which option is chosen by the model based on its response, without seeing the context of the question. The extracted option should be one of the provided option letters. Your should first briefly give your reasoning process, and then give the extracted option letter. The extracted option must strictly follow this format: \"[[option letter]]\", e.g., \"The option chosen by the model: [[A]]\".
Below are some examples.

Example 1:
Question: What did he do to the car?
Options:
A. Paint the car
B. Put plastic over the car
C. Put metal over the car
D. Cut the car
Model's Answer: put plastic over the car.
Your Judgment: The model's response directly aligns with option B, which is "Put plastic over the car." The response given is a paraphrase of this option without deviating in meaning. The option chosen by the model: [[B]]

Example 2:
Question: How did Eddie know Pam and Justin before Justin was killed?
Options:
A. They were part of the theater company
B. They were high school friends
C. They went to college together
D. They were cousins
E. They were siblings
Model's Answer: A.
Your Judgment: The model's answer directly provides the option letter "A." The option chosen by the model: [[A]]

Example 3:
Question: why do the people move in the same manner
Options:
A. uniform
B. dancing with the baby
C. exercising together
D. stay together
E. singing and dancing
Model's Answer: sing and dance
Your Judgment: The model's response "sing and dance" closely aligns with option E, which is "singing and dancing." The response provided is a direct paraphrase of this option, modifying only slightly the form of the words (from gerund to infinitive) but maintaining the same core activities described in the option. The option chosen by the model: [[E]]

When you think that the model's answer does not match any of the given options, please choose the option that is the closest to the model's answer.
Give the brief reasoning process and the extracted option for the below case.

Question: {prompt}
Options:
{options}
Model's Answer: {response}
Your Judgment:
"""
# Same trailing-space byte-parity for the extractor (utils.py:300-346).
MC_USER_TEMPLATE = MC_USER_TEMPLATE.replace(
    "Below are some examples.\n", "Below are some examples. \n").replace(
    "for the below case.\n", "for the below case. \n").replace(
    "Options:\n{options}", "Options: \n{options}").replace(
    "Your Judgment:\n", "Your Judgment: \n")

_SCORE_RE = re.compile(r"\[\[(\d+\.?\d*)\]\]")
_SCORE_BACKUP_RE = re.compile(r"\[(\d+\.?\d*)\]")


def doc_to_visual(doc, data_root: str = ""):
    """First input_file entry with the mp4 -> MP4 fallback
    (utils.py:152-175); the VideoITG adapters consume one video."""
    name = str(doc["input_file"][0] if isinstance(doc["input_file"], list)
               else doc["input_file"])
    for cand in (name, name.replace("mp4", "MP4")):
        path = os.path.join(data_root, cand) if data_root else cand
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(data_root, name))


def doc_to_text(doc, pre_prompt: str = PRE_PROMPT, post_prompt: str = ""):
    """utils.py:183-215: query, lettered options block, pre/post joins."""
    user_prompt = doc["query"]
    options = doc.get("options") or []
    if len(options) > 1:
        option_prompt = "Here are the options:\n"
        for idx, option in enumerate(options):
            option_prompt += f"{chr(ord('A') + idx)}. {option.strip()}\n"
        user_prompt = f"{user_prompt}\n{option_prompt.rstrip(chr(10))}"
    if pre_prompt:
        user_prompt = f"{pre_prompt}\n{user_prompt}"
    if post_prompt:
        user_prompt = f"{user_prompt}\n{post_prompt}"
    return user_prompt


def mc_extract_messages(doc: dict, response: str) -> List[dict]:
    options = "\n".join(f"{chr(ord('A') + i)}. {o}"
                        for i, o in enumerate(doc.get("options") or []))
    return [{"role": "system", "content": MC_SYSTEM},
            {"role": "user", "content": MC_USER_TEMPLATE.format(
                prompt=doc["query"], options=options, response=response)}]


def freeform_messages(question: str, gold_ans: str,
                      response: str) -> List[dict]:
    return [{"role": "system", "content": FREEFORM_SYSTEM},
            {"role": "user", "content": FREEFORM_USER_TEMPLATE.format(
                prompt=question, gold_ans=gold_ans, response=response)}]


def parse_judge_score(reply: str) -> float:
    """utils.py:87-101 minus the random fallback: [[x]] then [x], else 0.0."""
    m = _SCORE_RE.search(reply or "") or _SCORE_BACKUP_RE.search(reply or "")
    if not m:
        return 0.0
    try:
        return float(ast.literal_eval(m.group(1)))
    except Exception:
        return 0.0


def _gold_answer_str(doc) -> str:
    """utils.py:264-266: bracketed, quoted golden-answer list."""
    refs = doc["reference_answer"]
    if not isinstance(refs, (list, tuple)):
        refs = [refs]
    return "[" + ", ".join(f'"{gt}"' for gt in refs) + "]"


def process_results_mc(doc, response: str) -> dict:
    """Response arrives ALREADY filtered to an index string by
    gpt_mc_extract; exact_match vs reference_answer with ignore_case +
    ignore_punctuation (mix_evals_video2text_mc.yaml:13-18)."""
    target = doc["reference_answer"]
    if isinstance(target, (list, tuple)):
        target = target[0] if target else ""
    hit = exact_match(str(response), [str(target)], ignore_case=True,
                      ignore_punctuation=True)
    return {"id": doc.get("id"), "query": doc["query"],
            "pred_index": str(response), "target": str(target),
            "exact_match": hit}


def process_results_freeform(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    gold = _gold_answer_str(doc)
    reply = judge(freeform_messages(doc["query"], gold, pred),
                  max_tokens=999)
    return {"id": doc.get("id"), "query": doc["query"], "pred": pred,
            "target": doc["reference_answer"], "eval_answer": reply,
            "score": parse_judge_score(reply), "judge_model": judge.name}


def _agg_mc(name: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{name}_exact_match": 0.0}
        return {f"{name}_exact_match":
                sum(r["exact_match"] for r in records) / len(records)}

    return aggregate


def _agg_freeform(name: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{name}_gpt_eval": 0.0}
        return {f"{name}_gpt_eval":
                sum(r["score"] for r in records) / len(records)}

    return aggregate


def _load(split: str):
    def load_docs(data_root: str, split_override: str = "") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("MixEval/MixEval-X", data_root,
                                   split_override or split,
                                   subset="video2text")

    return load_docs


for _suffix, _split in (("", ""), ("_hard", "_hard")):
    _mc = f"mix_evals_video2text_mc{_suffix}"
    register_task(Task(
        name=_mc,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results_mc,
        aggregate=_agg_mc(_mc),
        load_docs=_load(f"multiple_choice{_split}"),
        doc_id_key=None,
        primary_metric=f"{_mc}_exact_match",
        filters=[("gpt_mc_extract", None)],
        prompt_overrides={
            "default": {"pre_prompt": PRE_PROMPT,
                        "post_prompt": MC_POST_PROMPT},
            "gpt4v": {"pre_prompt": PRE_PROMPT,
                      "post_prompt": MC_POST_PROMPT},
        },
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))
    _ff = f"mix_evals_video2text_freeform{_suffix}"
    _ff_post = FREEFORM_HARD_POST_PROMPT if _suffix else ""
    register_task(Task(
        name=_ff,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results_freeform,
        aggregate=_agg_freeform(_ff),
        load_docs=_load(f"free_form{_split}"),
        doc_id_key=None,
        primary_metric=f"{_ff}_gpt_eval",
        prompt_overrides={
            "default": {"pre_prompt": PRE_PROMPT, "post_prompt": _ff_post},
            "gpt4v": {"pre_prompt": (PRE_PROMPT if not _suffix else
                                     "These are frames from a video. "
                                     "Please answer the following questions "
                                     "about the video with a short phrase."),
                      "post_prompt": ""},
        },
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))

register_group("mix_evals_video2text",
               ["mix_evals_video2text_mc", "mix_evals_video2text_freeform"])
register_group("mix_evals_video2text_hard",
               ["mix_evals_video2text_mc_hard",
                "mix_evals_video2text_freeform_hard"])
