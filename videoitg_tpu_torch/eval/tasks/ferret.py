"""Ferret-Bench (parity: lmms_eval/tasks/ferret/utils.py + rule.json +
ferret.yaml).

Region-grounded image QA judged PAIRWISE against a GPT reference answer
(lmms-lab/Ferret-Bench, split test). Docs carry question / gpt_answer
(Assistant 1) / context (list of caption sentences + object/relationship
annotations) / category (refer_desc | refer_reason | ground_conv) /
image. The judge content interleaves [Context]/[Question]/[Assistant 1]/
[Assistant 2]/[System] with the category's rule.json prompt
(utils.py:125-135) under the shared llava-bench system message; the
review's FIRST line must be two scores (parse_score, utils.py:89-101).

Aggregation (utils.py:187-206): per category, mean over the [s1, s2]
pairs, reported as round(mean_s2 / mean_s1 * 100, 1). The reference's
multi-metric [-999, -999] other-category sentinel plumbing
(utils.py:156-165) is replaced by records carrying their category —
same numbers, no sentinel rows. [-1, -1] judge-failure pairs are
INCLUDED in the means, as upstream.

The rule prompts below are verbatim behavioral constants from
ferret/rule.json (the judge instruction IS the metric).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.llava_bench import (
    SYSTEM_MSG,
    _relative,
    doc_to_visual,
    parse_score,
)
from videoitg_tpu_torch.eval.judge import get_judge

FERRET_CATEGORIES = ("refer_desc", "refer_reason", "ground_conv")

# ferret/rule.json — verbatim. The three categories share one head about
# the region-annotation context; ground_conv swaps in the
# coordinate-precision rating sentence.
_REGION_CONTEXT_HEAD = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. ")

_REFER_BODY = (
    "The user asks the question about specific region of an image. For "
    "your reference, the visual content in the image is represented with "
    "five descriptive sentences describing the same image. In addition, "
    "specific object locations within the image are given, along with "
    "detailed coordinates. These coordinates are in the form of bounding "
    "boxes, represented as (x1, y1, x2, y2) with floating numbers ranging "
    "from 0 to 1. These values correspond to the top left x, top left y, "
    "bottom right x, and bottom right y. Also, the relationships between "
    "pairs of objects are provided, in the format of object -> "
    "relationship -> subject, where the object/subject are indexed by "
    "object id from previous object lists as well as the object names. "
    "Also, several region description are given, each describing a box "
    "region of image, with detailed coordinates. \n"
    "Please rate the spatial correspondence, helpfulness, relevance, "
    "accuracy, level of details of their responses. Each assistant "
    "receives an overall score on a scale of 1 to 10, where a higher "
    "score indicates better overall performance.\n")

_GROUND_BODY = (
    "The user asks the question that requires model to predict the "
    "coordinates of relevant object. For your reference, the visual "
    "content in the image is represented with five descriptive sentences "
    "describing the same image. In addition, specific object locations "
    "within the image are given, along with detailed coordinates. These "
    "coordinates are in the form of bounding boxes, represented as "
    "(x1, y1, x2, y2) with floating numbers ranging from 0 to 1. These "
    "values correspond to the top left x, top left y, bottom right x, "
    "and bottom right y. Also, the relationships between pairs of "
    "objects are provided, in the format of object -> relationship -> "
    "subject, where the object/subject are indexed by object id from "
    "previous object lists as well as the object names. Also, several "
    "region description are given, each describing a box region of "
    "image, with detailed coordinates. \n"
    "Please rate the predicted coordinates, helpfulness, relevance, "
    "accuracy, level of details of their responses. Specifically, pay "
    "your attention to the precision of the coordinates and whether it "
    "matches the object. Small deviation (<20% of ground-truth box width "
    "or height) of coordinates is allowed and shouldn't be punished. "
    "More than that, the degree of deviation should be reflected in "
    "scoring too.  Each assistant receives an overall score on a scale "
    "of 1 to 10, where a higher score indicates better overall "
    "performance.\n")

_OUTPUT_FORMAT_TAIL = (
    "Please first output a single line containing only two values "
    "indicating the scores for Assistant 1 and 2, respectively. The two "
    "scores are separated by a space.\n"
    "In the subsequent line, please provide a comprehensive explanation "
    "of your evaluation, avoiding any potential bias and ensuring that "
    "the order in which the responses were presented does not affect "
    "your judgment.")

RULES = {
    "refer_desc": {"role": "Assistant",
                   "prompt": _REGION_CONTEXT_HEAD + _REFER_BODY
                   + _OUTPUT_FORMAT_TAIL},
    "refer_reason": {"role": "Assistant",
                     "prompt": _REGION_CONTEXT_HEAD + _REFER_BODY
                     + _OUTPUT_FORMAT_TAIL},
    "ground_conv": {"role": "Assistant",
                    "prompt": _REGION_CONTEXT_HEAD + _GROUND_BODY
                    + _OUTPUT_FORMAT_TAIL},
}


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    """utils.py:108-114."""
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    """utils.py:117-168 — build the judge content and score once; the
    record carries its category instead of the reference's per-metric
    [-999, -999] sentinel copies."""
    question = doc.get("question", "")
    ans1 = doc.get("gpt_answer", "")
    context = doc.get("context", [])
    context = "\n".join(context) if isinstance(context, list) else context
    category = doc.get("category", "")
    rule = RULES.get(category, {})
    prompt, role = rule.get("prompt", ""), rule.get("role", "user")
    content = (f"[Context]\n{context}\n\n"
               f"[Question]\n{question}\n\n"
               f"[{role} 1]\n{ans1}\n\n[End of {role} 1]\n\n"
               f"[{role} 2]\n{response}\n\n[End of {role} 2]\n\n"
               f"[System]\n{prompt}\n\n")
    judge = get_judge()
    try:
        review = judge([{"role": "system", "content": SYSTEM_MSG},
                        {"role": "user", "content": content}],
                       max_tokens=1024)
        scores = parse_score(review)
    except Exception:
        scores = [-1, -1]
    return {"question": question, "ans1": ans1, "ans2": response,
            "category": category, "scores": scores}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:171-206: relative score overall + per category."""
    out = {"gpt_eval_ferret_all": _relative([r["scores"] for r in records])}
    for cat in FERRET_CATEGORIES:
        sub = [r["scores"] for r in records if r["category"] == cat]
        if sub:
            out[f"gpt_eval_ferret_{cat}"] = _relative(sub)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/Ferret-Bench", data_root, split)


register_task(Task(
    name="ferret",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("gpt_answer", ""),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="gpt_eval_ferret_all",
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                       "do_sample": False},
))
