"""lmms-lab internal eval suite (parity: lmms_eval/tasks/internal_eval/:
d170_en_utils.py, d170_cn_utils.py, dc100_en_utils.py, dc200_cn_utils.py,
utils.py + the four yamls + internal_eval.yaml group).

Four judge-scored image tasks over lmms-lab's internal datasets:

* ``d170_en`` / ``d170_cn`` (lmms-lab/D170_v4.1_EN / _CN, split test):
  open QA graded 0/1/2 against doc["annotation"] with the
  EVALUATION_PROMPT_TEMPLATE_SIMPLE_V2 rubric (d170_en_utils.py:28-36 —
  includes the grounding-IoU scoring clause); the score is parsed from
  "Score:\\s*(\\d)" and defaults to 0 (d170_en_utils.py:105-108).
  Metrics: gpt_eval_avg_score (mean) and gpt_eval_score2_rate (share of
  exact-2 scores, d170_en_utils.py:133-139).
* ``dc100_en`` / ``dc200_cn`` (lmms-lab/DC100_EN / DC200_CN, test):
  detailed-caption rating 0-100 with
  EVALUATION_PROMPT_TEMPLATE_SIMPLE_V1 (dc100_en_utils.py:37-41), the
  IMAGE attached to the judge call, score parsed from "Final Score:
  (\\d+)" else 0 (dc100_en_utils.py:95-106). Metric: gpt_eval_avg_score.

Both prompt templates are verbatim behavioral constants. The CN
variants are byte-identical logic on the CN datasets (verified by diff
— only yaml/file names differ).
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.llava_bench import _b64

# d170_en_utils.py:28-36 — verbatim.
D170_PROMPT = """You are an expert in judging the quality of a model response compared with given ground truth. The model response is in English while the ground truth can be in English or Chinese, or both. You should only judge the relevance of the model response to the ground truth based on meanings, not the language.
If the model response and ground truth are about grounding object coordinates, you may pay attention that the model responses are in format of [x_min, y_min, x_max, y_max]. You could judge the grounding quality by the IoU of the model response and the ground truth, or the distance between the center of the model response and the ground truth. If IoU is above 0.5 or the distance is below 0.3, you could give a score of 2. If IoU is below 0.2 or the distance is above 0.5, you could give a score of 0. If IoU is between 0.2 and 0.5 or the distance is between 0.2 and 0.5, you could give a score of 1.
Your response should be an integer score in [0, 1, 2], where 0 means the model response is completely irrelevant to the ground truth, and 2 means the model response completely matches the ground truth. You would have specific score criteria in the ground truth. You also need to explain your score in English.
Text: {prompt}
Ground Truth: {ground_truth}
You should response by following format:
Score:
Explanation:"""

# dc100_en_utils.py:37-41 — verbatim (dc200_cn uses the same English
# template; only the dataset is Chinese). The reference line 39 ends in
# a TRAILING SPACE — appended via concatenation so whitespace-stripping
# tooling can't silently change the metric.
DC_PROMPT = (
    """Text Caption: {caption}
From 0 to 100, how much do you rate for this Text Caption in terms of the correct and comprehensive description of the image?
Do not dominant the rating by a single attribute such as recognition correctness, but a overall rating on the object/scene appearance, position, pose, action, shape, etc., and contents in the background."""
    + " " + """
Do not consider the appropriateness or sensitive descriptors, such as "middle-aged western man", judge based on if it has correct specifications of the object and scenes in image.
Provide a few lines for explanation and the rate number at last after "Final Score:"."""
)

_D170_SCORE_RE = re.compile(r"Score:\s*(\d)")
_DC_SCORE_RE = re.compile(r"Final Score: (\d+)")


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    """internal_eval/utils.py:1-7."""
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    """d170_en_utils.py:85-88 — None image -> no visuals."""
    img = doc.get("image")
    if img is None:
        return []
    return [img]


def process_results_d170(doc, response: str) -> dict:
    """d170_en_utils.py:91-120."""
    prompt = D170_PROMPT.format(prompt=response,
                                ground_truth=doc["annotation"])
    try:
        review = get_judge()([{"role": "user", "content": prompt}],
                             max_tokens=512)
    except Exception:
        review = ""
    m = _D170_SCORE_RE.findall(review)
    score = int(m[0]) if m else 0
    return {"question_id": doc.get("question_id"), "prediction": response,
            "ground_truth": doc["annotation"], "response": review,
            "score": score}


def process_results_dc(doc, response: str) -> dict:
    """dc100_en_utils.py:95-114 — caption rating with the image attached
    to the judge (the OpenAI vision part-list shape; offline judges read
    the text part via judge.content_text)."""
    prompt = DC_PROMPT.format(caption=response)
    parts = [{"type": "text", "text": prompt}]
    b64 = _b64(doc.get("image"))
    if b64:
        parts.append({"type": "image_url",
                      "image_url": f"data:image/jpeg;base64,{b64}"})
    try:
        review = get_judge()([{"role": "user", "content": parts}],
                             max_tokens=1024)
    except Exception:
        review = ""
    m = _DC_SCORE_RE.search(review)
    score = int(m.group(1)) if m else 0
    return {"question_id": doc.get("question_id"), "prediction": response,
            "response": review, "score": score}


def aggregate_d170(records: List[dict]) -> Dict[str, float]:
    """d170_en_utils.py:125-139."""
    if not records:
        return {"gpt_eval_avg_score": 0.0, "gpt_eval_score2_rate": 0.0}
    n = len(records)
    return {
        "gpt_eval_avg_score": sum(r["score"] for r in records) / n,
        "gpt_eval_score2_rate":
            sum(r["score"] == 2 for r in records) / n,
    }


def aggregate_dc(records: List[dict]) -> Dict[str, float]:
    """dc100_en_utils.py:125-131."""
    if not records:
        return {"gpt_eval_avg_score": 0.0}
    return {"gpt_eval_avg_score":
            sum(r["score"] for r in records) / len(records)}


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 1024, "temperature": 0, "do_sample": False}

for _name, _hub, _proc, _agg in (
        ("d170_en", "lmms-lab/D170_v4.1_EN", process_results_d170,
         aggregate_d170),
        ("d170_cn", "lmms-lab/D170_v4.1_CN", process_results_d170,
         aggregate_d170),
        ("dc100_en", "lmms-lab/DC100_EN", process_results_dc,
         aggregate_dc),
        ("dc200_cn", "lmms-lab/DC200_CN", process_results_dc,
         aggregate_dc)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("annotation", ""),
        process_results=_proc,
        aggregate=_agg,
        primary_metric="gpt_eval_avg_score",
        load_docs=_make_load(_hub),
        generation_kwargs=dict(_GEN),
    ))

register_group("internal_eval", ["d170_cn", "d170_en", "dc100_en",
                                 "dc200_cn"])
