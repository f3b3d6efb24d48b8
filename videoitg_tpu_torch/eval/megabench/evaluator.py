"""Per-task scoring driver (parity: lmms_eval/tasks/megabench/
evaluator.py:93-340 — parse each response per the task's
response_parse_function, score every answer field with its
field_score_function, aggregate with mean/min over field_weights)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from videoitg_tpu_torch.eval.megabench.parsing import (
    evaluate_as_string,
    is_single_field_parser,
    parse_response,
)
from videoitg_tpu_torch.eval.megabench.scoring import (
    CONTEXT_INFO_METRICS,
    CONTEXT_METRICS,
    JUDGE_METRICS,
    get_metric,
)


def aggregate_fields(function: Optional[str], scores: Dict[str, float],
                     weights: Dict[str, float]) -> float:
    """aggregation_type.py + aggregation/{mean,min,unsupported}_agg.py:
    scores < 0 (unsupported) are excluded; all-unsupported -> -1."""
    name = (function or "unsupported").lower()
    filtered = {f: s for f, s in scores.items() if s >= 0}
    if not filtered:
        return -1
    if name == "mean":
        total_w = sum(weights[f] for f in filtered)
        if not total_w:
            return -1
        return sum(s * weights[f] for f, s in filtered.items()) / total_w
    if name == "min":
        return min(filtered.values())
    return -1


def _parse_query_response(parser_name: str, response_text: str,
                          correct_answer: Dict[str, Any],
                          answer_fields: List[str]):
    """evaluator.py:289-337."""
    if is_single_field_parser(parser_name):
        assert len(answer_fields) == 1, \
            "answer_string parsing needs a single answer field"
        answer_key = answer_fields[0]
        is_single_line = "\n" not in correct_answer[answer_key]
        return parse_response(parser_name, response_text,
                              answer_key=answer_key,
                              is_single_line_ans=is_single_line)
    response_obj = parse_response(parser_name, response_text)
    if (parser_name or "").lower() == "json" and (
            not isinstance(response_obj, dict) or not response_obj):
        # JSON expected but parsing failed: every field sees the raw
        # response (evaluator.py:325-333).
        return {field: response_text for field in correct_answer}
    return response_obj


def score_query(query: Dict[str, Any], score_config: Dict[str, Any],
                eval_context: Optional[dict] = None) -> Dict[str, Any]:
    """Score one (response, correct_answer) pair; returns the scores
    dict the reference attaches to the query (evaluator.py:160-192)."""
    field_score_functions = score_config.get("field_score_function", {})
    global_aux_metrics = score_config.get("global_aux_metrics", {})
    parser_name = score_config.get("response_parse_function", "dummy")
    aggregation = score_config.get("aggregation",
                                   {"function": None, "field_weights": {}})

    correct_answer = query["correct_answer"]
    answer_fields = [f for f in correct_answer if not f.startswith("##")]
    response_obj = _parse_query_response(
        parser_name, query.get("response", ""), correct_answer,
        answer_fields)

    scores = {"field": {}, "info": {}}

    def eval_field(fld, metric_name, resp_obj, is_aux=False):
        key, metric = get_metric(metric_name, score_config)
        if key == "unsupported":
            scores["field"][fld] = -1
            return
        if key in CONTEXT_METRICS:
            scores["field"][fld] = metric.match(
                resp_obj.get(fld) if isinstance(resp_obj, dict)
                else resp_obj, eval_context)
        elif key in CONTEXT_INFO_METRICS:
            score, info = metric.match(
                resp_obj.get(fld) if isinstance(resp_obj, dict)
                else resp_obj, eval_context)
            scores["field"][fld] = score
            scores["info"][fld] = info
        elif key in JUDGE_METRICS and key == "gpt_4o_as_judge":
            response_info = (resp_obj.get(fld)
                             if isinstance(resp_obj, dict) else resp_obj)
            score, info = metric.match(response_info, correct_answer,
                                       query.get("images"),
                                       query.get("query_text", ""),
                                       eval_context)
            scores["field"][fld] = score
            scores["info"][fld] = info
        else:
            correct_val = (correct_answer.get(fld, "")
                           if not is_aux else correct_answer)
            correct_val = evaluate_as_string(correct_val)
            predicted = (resp_obj.get(fld, "")
                         if isinstance(resp_obj, dict) else resp_obj)
            try:
                scores["field"][fld] = metric.match(predicted,
                                                    correct_val)
            except Exception:
                scores["field"][fld] = 0

    for fld, metric_name in field_score_functions.items():
        eval_field(fld, metric_name, response_obj)
    for fld, metric_name in global_aux_metrics.items():
        # aux metrics see the whole response object under their key
        # (evaluator.py:172-186)
        eval_field(fld, metric_name, {fld: response_obj}, is_aux=True)

    scores["query"] = aggregate_fields(
        aggregation.get("function"),
        scores["field"], aggregation.get("field_weights", {}))
    return scores


def score_task(query_responses: List[Dict[str, Any]],
               score_config: Dict[str, Any],
               eval_contexts: Optional[Dict[Any, dict]] = None) -> dict:
    """Score every query of one task (evaluator.py:124-215). Returns
    {task_score, mean_task_score, query_scores}."""
    task_score_sum = 0.0
    query_scores = []
    for query in query_responses:
        ctx = None
        if eval_contexts is not None:
            ctx = eval_contexts.get(query.get("global_idx"))
        if ctx is None:
            ctx = query.get("eval_context") or {}
        scores = score_query(query, score_config, ctx)
        query_scores.append(scores)
        if scores["query"] >= 0:
            task_score_sum += scores["query"]
    n = len(query_responses)
    return {
        "task_score": task_score_sum,
        "mean_task_score": task_score_sum / n if n else 0.0,
        "query_scores": query_scores,
    }
