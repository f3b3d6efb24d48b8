"""ActivityNet-QA open-ended video QA, judge-scored.

Parity: lmms_eval/tasks/activitynetqa/ — docs carry video_name /
question / answer / question_id / type. Prompt: the question capitalized
with "?" appended plus the yaml post_prompt " Answer the question using
a single word or phrase." (utils.py:63-87 +
_default_template_yaml:8-11). Scoring sends the reference's exact judge
messages (system + user, utils.py:93-117) to the configured judge
backend (eval/judge.py; --judge http:gpt-3.5-turbo-1106 reproduces the
reference setup; the offline default is the documented exact-match
stand-in) and parses the {'pred','score'} dict reply with the
reference's brace-extraction + ast.literal_eval (utils.py:158-179;
failures -> ["no", 0]). Metrics (utils.py:246-285): accuracy
(yes / (yes+no), x100) and average 0-5 score.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

POST_PROMPT = " Answer the question using a single word or phrase."

SYSTEM_MSG = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct "
    "answer and determine if they match meaningfully. Here's how you "
    "can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and "
    "the correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the "
    "answer.")


def judge_messages(question: str, answer: str, pred: str) -> List[dict]:
    """The reference's judge payload, field-for-field (utils.py:95-117)."""
    user = (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a yes/no and score where the "
        "score is an integer value between 0 and 5, with 5 indicating "
        "the highest meaningful match. "
        "Please generate the response in the form of a Python "
        "dictionary string with keys 'pred' and 'score', where value of "
        "'pred' is  a string of 'yes' or 'no' and value of 'score' is "
        "in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide the Python dictionary string. "
        "For example, your response should look like this: "
        "{'pred': 'yes', 'score': 4.8}.")
    return [{"role": "system", "content": SYSTEM_MSG},
            {"role": "user", "content": user}]


def parse_score(review: str):
    """Reference parse_score (utils.py:158-179): brace extraction +
    ast.literal_eval; any failure -> ['no', 0]."""
    try:
        review = "{" + review.split("{")[1].split("}")[0] + "}"
        d = ast.literal_eval(review)
        score = int(d["score"])
        pred = d["pred"]
        if "yes" in pred.lower():
            pred = "yes"
        elif "no" in pred.lower():
            pred = "no"
        return [pred, score]
    except Exception:
        return ["no", 0]


def doc_to_visual(doc, data_root: str = ""):
    base = os.path.join(data_root, "all_test") if data_root else "all_test"
    for ext in ("mp4", "webm", "mkv"):
        path = os.path.join(base, f"v_{doc['video_name']}.{ext}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        os.path.join(base, f"v_{doc['video_name']}.mp4"))


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = POST_PROMPT):
    question = doc["question"].capitalize() + "?"
    return f"{pre_prompt}{question}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    review = judge(judge_messages(doc["question"], doc["answer"], pred),
                   max_tokens=64)
    correctness, score = parse_score(review)
    return {
        "video_name": doc["video_name"],
        "question": doc["question"],
        "answer": doc["answer"],
        "pred": pred,
        "question_id": doc.get("question_id"),
        "type": doc.get("type"),
        "Correctness": correctness,
        "score": score,
        "judge_model": judge.name,
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    yes = sum(1 for r in records if "yes" in r["Correctness"].lower())
    no = sum(1 for r in records if "no" in r["Correctness"].lower())
    total = sum(int(r["score"]) for r in records)
    acc = yes / (yes + no) if (yes + no) else 0.0
    avg = total / len(records) if records else 0.0
    return {"activitynetqa_accuracy": acc * 100.0,
            "activitynetqa_score": avg}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/ActivityNetQA", data_root, split)


register_task(Task(
    name="activitynetqa",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="activitynetqa_accuracy",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
