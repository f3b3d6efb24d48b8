"""VideoChatGPT benchmark (generic / temporal / consistency), judge-scored.

Parity: lmms_eval/tasks/videochatgpt/ — docs carry video_name / question
/ answer (generic+temporal) or video_name / question_1 / question_2 /
answer (consistency; each doc holds one live question, the other is the
string "None", and pairs share video_name). Prompts are the bare
question (utils.py:68-99). Scoring routes the reference's exact judge
messages (utils.py:220-388: correctness / detailed_orientation /
context / temporal / consistency system+user prompts, verbatim incl.
the "{''score': 4.8}" example typo) through the configured judge backend
(eval/judge.py) and parses with the reference's parse_score
(utils.py:428-442: direct ast.literal_eval + .get('score', 0)).
Aggregation is the 0-5 average score per metric (utils.py:570-579);
consistency pairs predictions by video_name at aggregate time exactly
like videochatgpt_aggregate_submissions_consistency (utils.py:182-215)
and judges each pair once.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge

_COMMON_TAIL = (
    "Please generate the response in the form of a Python dictionary "
    "string with keys 'score', where its value is {what} in INTEGER, "
    "not STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide "
    "the Python dictionary string. "
    "For example, your response should look like this: {{''score': 4.8}}.")

_DIMENSIONS = {
    "correctness": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the "
            "factual accuracy of generative outputs for video-based "
            "question-answer pairs. "
            "Your task is to compare the predicted answer with the "
            "correct answer and determine if they are factually "
            "consistent. Here's how you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the factual consistency between the predicted "
            "answer and the correct answer. The predicted answer should "
            "not contain any misinterpretations or misinformation.\n"
            "- The predicted answer must be factually accurate and "
            "align with the video content.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Evaluate the factual accuracy of the prediction compared "
            "to the answer."),
        "ask": ("Provide your evaluation only as a factual accuracy "
                "score where the factual accuracy score is an integer "
                "value between 0 and 5, with 5 indicating the highest "
                "level of factual consistency. "),
        "what": "the factual accuracy score",
    },
    "detailed_orientation": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the "
            "detail orientation of generative outputs for video-based "
            "question-answer pairs. "
            "Your task is to compare the predicted answer with the "
            "correct answer and determine its level of detail, "
            "considering both completeness and specificity. Here's how "
            "you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Check if the predicted answer covers all major points "
            "from the video. The response should not leave out any key "
            "aspects.\n"
            "- Evaluate whether the predicted answer includes specific "
            "details rather than just generic points. It should provide "
            "comprehensive information that is tied to specific "
            "elements of the video.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Provide a single evaluation score that reflects the "
            "level of detail orientation of the prediction, considering "
            "both completeness and specificity."),
        "ask": ("Provide your evaluation only as a detail orientation "
                "score where the detail orientation score is an integer "
                "value between 0 and 5, with 5 indicating the highest "
                "level of detail orientation. "),
        "what": "the detail orientation score",
    },
    "context": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the "
            "contextual understanding of generative outputs for "
            "video-based question-answer pairs. "
            "Your task is to compare the predicted answer with the "
            "correct answer and determine if the generated response "
            "aligns with the overall context of the video content. "
            "Here's how you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Evaluate whether the predicted answer aligns with the "
            "overall context of the video content. It should not "
            "provide information that is out of context or misaligned.\n"
            "- The predicted answer must capture the main themes and "
            "sentiments of the video.\n"
            "- Consider synonyms or paraphrases as valid matches.\n"
            "- Provide your evaluation of the contextual understanding "
            "of the prediction compared to the answer."),
        "ask": ("Provide your evaluation only as a contextual "
                "understanding score where the contextual understanding "
                "score is an integer value between 0 and 5, with 5 "
                "indicating the highest level of contextual "
                "understanding. "),
        "what": "contextual understanding score",
    },
    "temporal": {
        "system": (
            "You are an intelligent chatbot designed for evaluating the "
            "temporal understanding of generative outputs for "
            "video-based question-answer pairs. "
            "Your task is to compare the predicted answer with the "
            "correct answer and determine if they correctly reflect the "
            "temporal sequence of events in the video content. Here's "
            "how you can accomplish the task:"
            "------"
            "##INSTRUCTIONS: "
            "- Focus on the temporal consistency between the predicted "
            "answer and the correct answer. The predicted answer should "
            "correctly reflect the sequence of events or details as "
            "they are presented in the video content.\n"
            "- Consider synonyms or paraphrases as valid matches, but "
            "only if the temporal order is maintained.\n"
            "- Evaluate the temporal accuracy of the prediction "
            "compared to the answer."),
        "ask": ("Provide your evaluation only as a temporal accuracy "
                "score where the temporal accuracy score is an integer "
                "value between 0 and 5, with 5 indicating the highest "
                "level of temporal consistency. "),
        "what": "the temporal accuracy score",
    },
}

CONSISTENCY_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the "
    "consistency of generative outputs for similar video-based "
    "question-answer pairs. "
    "You will be given two very similar questions, a common answer "
    "common to both the questions and predicted answers for the two "
    "questions ."
    "Your task is to compare the predicted answers for two very similar "
    "question, with a common correct answer and determine if they are "
    "consistent. Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the consistency between the two predicted answers and "
    "the correct answer. Both predicted answers should correspond to "
    "the correct answer and to each other, and should not contain any "
    "contradictions or significant differences in the conveyed "
    "information.\n"
    "- Both predicted answers must be consistent with each other and "
    "the correct answer, in terms of the information they provide about "
    "the video content.\n"
    "- Consider synonyms or paraphrases as valid matches, but only if "
    "they maintain the consistency in the conveyed information.\n"
    "- Evaluate the consistency of the two predicted answers compared "
    "to the correct answer.")


def dimension_messages(dim: str, question: str, answer: str,
                       pred: str) -> List[dict]:
    d = _DIMENSIONS[dim]
    user = (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        + d["ask"] + _COMMON_TAIL.format(what=d["what"]))
    return [{"role": "system", "content": d["system"]},
            {"role": "user", "content": user}]


def consistency_messages(q1: str, q2: str, answer: str, pred1: str,
                         pred2: str) -> List[dict]:
    user = (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question 1: {q1}\n"
        f"Question 2: {q2}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer to Question 1: {pred1}\n"
        f"Predicted Answer to Question 2: {pred2}\n\n"
        "Provide your evaluation only as a consistency score where the "
        "consistency score is an integer value between 0 and 5, with 5 "
        "indicating the highest level of consistency. "
        + _COMMON_TAIL.format(what="the consistency score"))
    return [{"role": "system", "content": CONSISTENCY_SYSTEM},
            {"role": "user", "content": user}]


def parse_score(review: str) -> int:
    """Reference utils.py:428-442: direct literal_eval, .get('score', 0)."""
    try:
        d = ast.literal_eval(review)
        return int(d.get("score", 0))
    except Exception:
        return 0


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "Test_Videos") if data_root else \
        "Test_Videos"
    for ext in (".mp4", ".MP4", ".mkv"):
        path = os.path.join(base, str(doc["video_name"]) + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        os.path.join(base, str(doc["video_name"]) + ".mp4"))


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = ""):
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def doc_to_text_consistency(doc, pre_prompt: str = "",
                            post_prompt: str = ""):
    question = (doc["question_1"] if doc["question_1"] != "None"
                else doc["question_2"])
    return f"{pre_prompt}{question}{post_prompt}"


def process_results_generic(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    rec = {"video_name": doc["video_name"], "Q": doc["question"],
           "A": doc["answer"], "pred": pred, "judge_model": judge.name}
    for dim in ("correctness", "detailed_orientation", "context"):
        review = judge(dimension_messages(dim, doc["question"],
                                          doc["answer"], pred), 64)
        rec[f"score_{dim}"] = parse_score(review)
    return rec


def process_results_temporal(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    review = judge(dimension_messages("temporal", doc["question"],
                                      doc["answer"], pred), 64)
    return {"video_name": doc["video_name"], "Q": doc["question"],
            "A": doc["answer"], "pred": pred,
            "score_temporal": parse_score(review),
            "judge_model": judge.name}


def process_results_consistency(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    rec = {"video_name": doc["video_name"], "A": doc["answer"]}
    if doc["question_1"] != "None":
        rec.update(Q1=doc["question_1"], pred1=pred)
    else:
        rec.update(Q2=doc["question_2"], pred2=pred)
    return rec


def _avg(records: List[dict], key: str) -> float:
    return (sum(r[key] for r in records) / len(records)) if records else 0.0


def aggregate_generic(records: List[dict]) -> Dict[str, float]:
    return {
        "videochatgpt_correctness": _avg(records, "score_correctness"),
        "videochatgpt_detailed_orientation":
            _avg(records, "score_detailed_orientation"),
        "videochatgpt_context": _avg(records, "score_context"),
    }


def aggregate_temporal(records: List[dict]) -> Dict[str, float]:
    return {"videochatgpt_temporal": _avg(records, "score_temporal")}


def aggregate_consistency(records: List[dict]) -> Dict[str, float]:
    # pair records by video_name, first unmatched wins (utils.py:189-211)
    judge = get_judge()
    used = set()
    scores = []
    for i, first in enumerate(records):
        if i in used or "pred1" not in first:
            continue
        for j in range(len(records)):
            second = records[j]
            if j in used or j == i or "pred2" not in second:
                continue
            if first["video_name"] == second["video_name"]:
                review = judge(consistency_messages(
                    first.get("Q1", ""), second.get("Q2", ""),
                    first["A"], first.get("pred1", ""),
                    second.get("pred2", "")), 64)
                scores.append(parse_score(review))
                used.update({i, j})
                break
    return {"videochatgpt_consistency":
            (sum(scores) / len(scores)) if scores else 0.0}


def _load(subset):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/VideoChatGPT", data_root,
                                   split, subset=subset)

    return load_docs


for _name, _subset, _text, _proc, _agg, _metric in (
        ("videochatgpt_generic", "Generic", doc_to_text,
         process_results_generic, aggregate_generic,
         "videochatgpt_correctness"),
        ("videochatgpt_temporal", "Temporal", doc_to_text,
         process_results_temporal, aggregate_temporal,
         "videochatgpt_temporal"),
        ("videochatgpt_consistency", "Consistency", doc_to_text_consistency,
         process_results_consistency, aggregate_consistency,
         "videochatgpt_consistency")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_text,
        process_results=_proc,
        aggregate=_agg,
        load_docs=_load(_subset),
        doc_id_key=None,
        primary_metric=_metric,
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))

register_group("videochatgpt", ["videochatgpt_generic",
                                "videochatgpt_temporal",
                                "videochatgpt_consistency"])
