"""CVRR-ES: Complex Video Reasoning & Robustness Evaluation Suite.

Parity: lmms_eval/tasks/cvrr/ — 11 evaluation-dimension subtasks over
lmms-lab/CVRR-ES (one dataset_name per dimension, _cvrr.yaml). Docs
carry VideoID / Q / A / DimensionName; the prompt is the bare question
(utils.py:87-101). Videos live under CVRR-ES/<dimension_dir>/<VideoID>
(utils.py:46-84 maps DimensionName -> directory). Scoring routes the
reference's exact judge payload (utils.py:110-130: correct/incorrect +
0-5 score + reason dict) through the configured judge backend
(eval/judge.py) and parses with the reference's direct-literal_eval
parse_score (utils.py:171-189; failures -> ('incorrect', 0, '')).
Metrics per subtask (utils.py:223-250): gpt_eval_accuracy =
correct-fraction x100, gpt_eval_score = mean 0-5. Group 'cvrr' averages
the subtask accuracies.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge

SYSTEM_MSG = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of AI assistant predictions for question-answer pairs. "
    "Your task is to compare the predicted answer with the ground-truth "
    "answer and determine if the predicted answer is correct or not. "
    "Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the correctness and accuracy of the predicted answer "
    "with the ground-truth.\n"
    "- Consider predictions with less specific details as correct "
    "evaluation, unless such details are explicitly asked in the "
    "question.\n")

# DimensionName (doc field) -> (task suffix == dataset_name == video dir)
DIMENSIONS: Dict[str, str] = {
    "Continuity and Object Instance Count":
        "continuity_and_object_instance_count",
    "Fine-grained action understanding":
        "fine_grained_action_understanding",
    "Interpretation of social context": "interpretation_of_social_context",
    "Interpretation of visual context": "interpretation_of_visual_context",
    "Multiple actions in a single video":
        "multiple_actions_in_a_single_video",
    "Non-existent actions with existent scene depictions":
        "non_existent_actions_with_existent_scene_depictions",
    "Non-existent actions with non-existent scene depictions":
        "non_existent_actions_with_non_existent_scene_depictions",
    "Partial actions": "partial_actions",
    "Time order understanding": "time_order_understanding",
    "Understanding of emotional context": "understanding_emotional_context",
    "Unusual and Physically Anomalous activities":
        "unusual_and_physically_anomalous_activities",
}


def judge_messages(question: str, answer: str, pred: str) -> List[dict]:
    """The reference's judge payload field-for-field (utils.py:110-130)."""
    user = (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Ground truth correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation as a correct/incorrect prediction along "
        "with the score where the score is an integer value between 0 "
        "(fully wrong) and 5 (fully correct). The middle score provides "
        "the percentage of correctness."
        "Please generate the response in the form of a Python dictionary "
        "string with keys 'pred', 'score' and 'reason', where value of "
        "'pred' is  a string of 'correct' or 'incorrect', value of "
        "'score' is in INTEGER, not STRING and value of 'reason' should "
        "provide the reason behind the decision."
        "Only provide the Python dictionary string."
        'For example, your response should look like this: '
        '{"pred": "correct", "score": 4.8, "reason": reason}.')
    return [{"role": "system", "content": SYSTEM_MSG},
            {"role": "user", "content": user}]


def parse_score(review: str):
    """Reference utils.py:171-189: direct literal_eval; failures ->
    ('incorrect', 0, '')."""
    try:
        d = ast.literal_eval(review)
        return (d.get("pred", "incorrect"), int(d.get("score", 0)),
                d.get("reason", ""))
    except Exception:
        return "incorrect", 0, ""


def doc_to_visual(doc, data_root: str = ""):
    """CVRR-ES/<dimension_dir>/<VideoID> (utils.py:46-84); VideoID carries
    its extension."""
    subdir = DIMENSIONS.get(doc["DimensionName"], "")
    base = os.path.join(data_root, "CVRR-ES", subdir) if data_root else \
        os.path.join("CVRR-ES", subdir)
    path = os.path.join(base, str(doc["VideoID"]))
    if os.path.exists(path):
        return path
    raise FileNotFoundError(path)


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = ""):
    return f"{pre_prompt}{doc['Q']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    review = judge(judge_messages(doc["Q"], doc["A"], pred), max_tokens=512)
    correctness, score, reason = parse_score(review)
    return {"VideoID": doc["VideoID"], "Q": doc["Q"], "A": doc["A"],
            "pred": pred, "DimensionName": doc["DimensionName"],
            "correctness": correctness, "score": score, "reason": reason,
            "judge_model": judge.name}


def _aggregate(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{prefix}_accuracy": 0.0, f"{prefix}_score": 0.0}
        correct = sum(1 for r in records if r["correctness"] == "correct")
        total = sum(int(r["score"]) for r in records)
        return {f"{prefix}_accuracy": correct / len(records) * 100.0,
                f"{prefix}_score": total / len(records)}

    return aggregate


def _load(subset: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/CVRR-ES", data_root, split,
                                   subset=subset)

    return load_docs


_MEMBERS = []
for _dim in DIMENSIONS.values():
    _name = f"cvrr_{_dim}"
    _MEMBERS.append(_name)
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=process_results,
        aggregate=_aggregate(_name),
        load_docs=_load(_dim),
        doc_id_key=None,
        primary_metric=f"{_name}_accuracy",
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))

register_group("cvrr", _MEMBERS)
