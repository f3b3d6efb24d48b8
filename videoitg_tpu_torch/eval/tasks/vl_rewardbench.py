"""VL-RewardBench (parity: lmms_eval/tasks/vl_rewardbench/utils.py +
vl_rewardbench.yaml).

Pairwise reward-model benchmark (MMInstruction/VL-RewardBench, split
test): the MODEL UNDER TEST is the judge — each doc carries a query,
two candidate responses, and human_ranking ([0,1] -> response 1 better).
doc_to_text builds the pairwise judging prompt with the answer order
decided by a deterministic pseudo-random bit (sum of response lengths
mod 2, utils.py:56-60 — the reference's own "random number generator",
preserved exactly). Scoring parses "Overall Judgment: Answer X is
better" (utils.py:63-82); when the regex misses, the reference asks a
gpt-4o-mini parser and finally random.choice — here the fallback goes
through the pluggable judge backend and then a deterministic crc32 coin
(documented divergence, same convention as eval/tasks/mmbench.py's
stand-in: offline runs stay reproducible).

Aggregation (utils.py:130-149): per-category macro average over the
group_mapping buckets (reasoning/hallucination/general).
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.llava_bench import doc_to_visual

# utils.py:10-15 — verbatim (the parse prompt is part of the metric).
LLM_PARSE_ANSWER_PROMPT = """
You are given a pairwise judgement for two responses. Please return the better response according to the judgement.
Return the Answer X ONLY. e.g., Answer 1 or Answer 2.

Judgement: {judgement}
"""

# utils.py:115-123.
GROUP_MAPPING = {
    "mathverse": "reasoning",
    "hallucination": "hallucination",
    "mmmu": "reasoning",
    "rlhf": "hallucination",
    "rlaif": "hallucination",
    "wildvision": "general",
    "vlfeedback": "general",
}

_JUDGMENT_RE = re.compile(
    r"(?:Overall Judgment|Therefore)\s*.*\s*-*\s*Answer\s*(\d+)\s*is\s*"
    r"(?:the\s*)?(?:slightly\s*)?better", re.IGNORECASE)


def _order_bit(doc) -> int:
    """utils.py:58 — sum of response lengths mod 2 decides answer order."""
    return sum(len(res) for res in doc["response"]) % 2


def get_prompt(doc, random_number: int) -> str:
    """utils.py:28-49 — verbatim judging prompt."""
    answers = ([doc["response"][0], doc["response"][1]] if random_number == 0
               else [doc["response"][1], doc["response"][0]])
    return f""" You are a highly capable multimodal AI assistant tasked with evaluating answers to visual questions. Please analyze the following image and question, then determine which of the two provided answers is better.

Question: {doc["query"]}

Answer 1: {answers[0]}

Answer 2: {answers[1]}

Please evaluate both answers based on the following criteria:
1. Accuracy: How well does the answer align with the visual information in the image?
2. Completeness: Does the answer fully address all aspects of the question?
3. Clarity: Is the answer easy to understand and well-articulated?
4. Relevance: Does the answer directly relate to the question and the image?

After your evaluation, please:
1. Explain your reasoning for each criterion.
2. Provide an overall judgment on which answer is better (Answer 1 or Answer 2). For example: Overall Judgment: Answer X is better.

Your response should be structured and detailed, demonstrating your understanding of both the visual and textual elements of the task."""


def doc_to_text(doc) -> str:
    """utils.py:56-60."""
    return get_prompt(doc, _order_bit(doc))


def parse_pred_ans(pred_ans: str, doc_id=None) -> int:
    """utils.py:63-82. Fallback chain: regex -> judge-backend parse ->
    deterministic crc32 coin (reference: gpt-4o-mini then
    random.choice([1, 2]) — the coin keeps offline runs reproducible)."""
    pred_ans = pred_ans.strip()
    m = _JUDGMENT_RE.search(pred_ans.replace("\n", "").replace("*", ""))
    if m:
        return int(m.group(1))
    try:
        parsed = get_judge()(
            [{"role": "user",
              "content": LLM_PARSE_ANSWER_PROMPT.format(judgement=pred_ans)}],
            max_tokens=32)
    except Exception:
        parsed = ""
    low = parsed.lower()
    if "answer 1" in low:
        return 1
    if "answer 2" in low:
        return 2
    return 1 + (zlib.crc32(f"{doc_id}|{pred_ans}".encode()) & 1)


def process_results(doc, response: str) -> dict:
    """utils.py:95-127."""
    pred_ans = parse_pred_ans(response, doc_id=doc.get("id"))
    random_number = _order_bit(doc)
    gt_ans = doc["human_ranking"].index(0 if random_number == 0 else 1) + 1
    score = 1.0 if pred_ans == gt_ans else 0.0
    category = doc["id"].split("-")[0].split("_")[0].lower()
    return {"question_id": doc["id"],
            "category": GROUP_MAPPING.get(category, "general"),
            "score": score}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:130-149 — macro average across categories."""
    if not records:
        return {"vlreward_score": 0.0}
    by_cat: Dict[str, list] = {}
    for r in records:
        by_cat.setdefault(r["category"], []).append(r["score"])
    cat_avg = {c: sum(v) / len(v) for c, v in by_cat.items()}
    out = {"vlreward_score": sum(cat_avg.values()) / len(cat_avg)}
    for c, v in sorted(cat_avg.items()):
        out[f"vlreward_{c}"] = v
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("MMInstruction/VL-RewardBench", data_root,
                               split)


register_task(Task(
    name="vl_rewardbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: str(doc.get("human_ranking", "")),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="vlreward_score",
    load_docs=load_docs,
    doc_id_key="id",
    generation_kwargs={"max_new_tokens": 1024, "temperature": 1.0,
                       "top_p": 1.0, "do_sample": True},
))
