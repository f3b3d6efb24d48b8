"""LLaVA-Bench family (parity: lmms_eval/tasks/llava-in-the-wild/
utils.py + rule.json; lmms_eval/tasks/llava-bench-coco/ — a clone
differing only in judge model/sleep; lmms_eval/tasks/llava_wilder/
utils.py + _default_template_wilder_yaml).

Open-ended image QA judged PAIRWISE against a reference answer:

* ``llava_in_the_wild`` (lmms-lab/llava-bench-in-the-wild, split
  train) and ``llava_bench_coco`` (lmms-lab/llava-bench-coco, train):
  docs carry question / gpt_answer (Assistant 1) / caption (context
  sentences) / category (conv|detail|complex) / image. The judge
  content interleaves [Context]/[Question]/[Assistant 1]/[Assistant 2]
  /[System] with the category's rule.json prompt (utils.py:128-138)
  under the fixed system message "You are a helpful and precise
  assistant for checking the quality of the answer." (utils.py:53-57);
  the review's FIRST line must be two scores (parse_score,
  utils.py:95-106 — commas tolerated, anything else -> [-1, -1]).
* ``llava_wilder_small`` (lmms-lab/LLaVA-Bench-Wilder, test): fields
  Question/Answer/image; one fixed judge rule (Assistant 1 pinned to
  10, utils.py:19) and the IMAGE is attached to the judge call
  (utils.py:57-74) — the message content is the OpenAI vision part
  list, passed through http judges verbatim and flattened to text by
  offline judges (judge.content_text).

Aggregation (utils.py:165-200): per category mean over the [s1, s2]
pairs (the -999 other-category sentinel rows of the reference's
multi-metric plumbing don't exist here — each record carries its
category instead), reported as round(mean_s2 / mean_s1 * 100, 1) —
the model's relative score vs the reference answer. [-1,-1] failure
pairs are INCLUDED in the means, as upstream.

The rule.json prompts below are verbatim behavioral constants (the
judge instruction IS the metric).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge

SYSTEM_MSG = ("You are a helpful and precise assistant for checking the "
              "quality of the answer.")

# rule.json (llava-in-the-wild == llava-bench-coco): the three
# llava_bench_* rules the tasks consult; role is "Assistant" for all.
_RELATIVE_RULES_TAIL = (
    "\nPlease rate the helpfulness, relevance, accuracy, level of details "
    "of their responses. Each assistant receives an overall score on a "
    "scale of 1 to 10, where a higher score indicates better overall "
    "performance.\nPlease first output a single line containing only two "
    "values indicating the scores for Assistant 1 and 2, respectively. "
    "The two scores are separated by a space.\nIn the subsequent line, "
    "please provide a comprehensive explanation of your evaluation, "
    "avoiding any potential bias and ensuring that the order in which "
    "the responses were presented does not affect your judgment.")

_LLAVA_BENCH_HEAD = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. The "
    "user asks the question on observing an image. For your reference, "
    "the visual content in the image is represented with a few sentences "
    "describing the image. ")

RULES = {
    f"llava_bench_{cat}": {"role": "Assistant",
                           "prompt": _LLAVA_BENCH_HEAD + _RELATIVE_RULES_TAIL}
    for cat in ("conv", "detail", "complex")
}

# llava_wilder/utils.py:19 — verbatim (Assistant 1 pinned to 10).
WILDER_RULE = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. The "
    "user asks the question on observing an image shown to you. \nPlease "
    "rate the helpfulness, relevance, accuracy, level of details of their "
    "responses. Each assistant receives an overall score on a scale of 1 "
    "to 10, where a higher score indicates better overall performance. "
    "Assume assistant 1 always receive a score of 10 and is the correct "
    "answer.\nPlease first output a single line containing only two "
    "values indicating the scores for Assistant 1 and 2, respectively. "
    "The two scores are separated by a space.\nIn the subsequent line, "
    "please provide a comprehensive explanation of your evaluation, "
    "avoiding any potential bias and ensuring that the order in which "
    "the responses were presented does not affect your judgment.")


def parse_score(review: str) -> List[float]:
    """utils.py:95-106."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split(" ")
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
        return [-1, -1]
    except Exception:
        return [-1, -1]


def _judge_review(content, judge=None) -> List[float]:
    judge = judge or get_judge()
    try:
        review = judge([{"role": "system", "content": SYSTEM_MSG},
                        {"role": "user", "content": content}],
                       max_tokens=1024)
    except Exception:
        return [-1, -1]
    return parse_score(review)


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def _make_doc_to_text(field: str):
    def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
        return f"{pre_prompt}{doc[field]}{post_prompt}"
    return doc_to_text


def process_results_wild(doc, response: str) -> dict:
    """llava-in-the-wild/utils.py:119-162."""
    question = doc.get("question", "")
    ans1 = doc.get("gpt_answer", "")
    captions = doc.get("caption", [])
    context = ("\n".join(captions) if isinstance(captions, list)
               else captions)
    category = "llava_bench_" + doc.get("category", "")
    rule = RULES.get(category, {})
    prompt, role = rule.get("prompt", ""), rule.get("role", "user")
    content = (f"[Context]\n{context}\n\n"
               f"[Question]\n{question}\n\n"
               f"[{role} 1]\n{ans1}\n\n[End of {role} 1]\n\n"
               f"[{role} 2]\n{response}\n\n[End of {role} 2]\n\n"
               f"[System]\n{prompt}\n\n")
    return {"question": question, "ans1": ans1, "ans2": response,
            "category": doc.get("category", "all"),
            "scores": _judge_review(content)}


def _b64(visual) -> Optional[str]:
    import base64
    import io

    if not hasattr(visual, "save"):
        return None
    buf = io.BytesIO()
    visual.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def process_results_wilder(doc, response: str) -> dict:
    """llava_wilder/utils.py:113-140 — image attached to the judge."""
    question = doc.get("Question", "")
    ans1 = doc.get("Answer", "")
    content = (f"[Question]\n{question}\n\n"
               f"[Assistant 1]\n{ans1}\n\n[End of Assistant 1]\n\n"
               f"[Assistant 2]\n{response}\n\n[End of Assistant 2]\n\n"
               f"[System]\n{WILDER_RULE}\n\n")
    parts = [{"type": "text", "text": content}]
    b64 = _b64(doc.get("image"))
    if b64:
        parts.append({"type": "image_url",
                      "image_url": f"data:image/jpeg;base64,{b64}"})
    return {"question": question, "ans1": ans1, "ans2": response,
            "category": "all", "scores": _judge_review(parts)}


def _relative(pairs: List[List[float]]) -> float:
    """utils.py:183-200: round(mean_s2 / mean_s1 * 100, 1)."""
    if not pairs:
        return 0.0
    m1 = sum(p[0] for p in pairs) / len(pairs)
    m2 = sum(p[1] for p in pairs) / len(pairs)
    m1, m2 = round(m1, 3), round(m2, 3)
    return round(m2 / m1 * 100, 1) if m1 else 0.0


def aggregate(records: List[dict]) -> Dict[str, float]:
    out = {"gpt_eval_llava_all": _relative([r["scores"] for r in records])}
    for cat in ("conv", "detail", "complex"):
        sub = [r["scores"] for r in records if r["category"] == cat]
        if sub:
            out[f"gpt_eval_llava_{cat}"] = _relative(sub)
    return out


def _make_load(hub: str, split: str, subset: Optional[str] = None):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split_, subset=subset)
    return load_docs


for _name, _hub, _split, _text_field, _proc, _gen in (
        ("llava_in_the_wild", "lmms-lab/llava-bench-in-the-wild", "train",
         "question", process_results_wild,
         {"max_new_tokens": 1024, "temperature": 0, "do_sample": False}),
        ("llava_bench_coco", "lmms-lab/llava-bench-coco", "train",
         "question", process_results_wild,
         {"max_new_tokens": 1024, "temperature": 0, "do_sample": False}),
        ("llava_wilder_small", "lmms-lab/LLaVA-Bench-Wilder", "test",
         "Question", process_results_wilder,
         {"max_new_tokens": 4096, "temperature": 0, "do_sample": False})):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_make_doc_to_text(_text_field),
        doc_to_target=lambda doc: doc.get("gpt_answer",
                                          doc.get("Answer", "")),
        process_results=_proc,
        aggregate=aggregate,
        primary_metric="gpt_eval_llava_all",
        load_docs=_make_load(_hub, _split),
        generation_kwargs=dict(_gen),
    ))


# Multilingual LLaVA-Bench-in-the-Wild (parity: lmms_eval/tasks/
# multilingual-llava-bench-in-the-wild/: utils.py is byte-identical to
# llava-in-the-wild's modulo the yaml filename — verified by diff — and
# rule.json is IDENTICAL, so the nine language tasks reuse
# process_results_wild/aggregate unchanged; each yaml only picks a
# dataset config on gagan3012/multilingual-llava-bench).
MULTILINGUAL_LANGS = ("arabic", "bengali", "chinese", "french", "hindi",
                      "japanese", "russian", "spanish", "urdu")

for _lang in MULTILINGUAL_LANGS:
    register_task(Task(
        name=f"llava_in_the_wild_{_lang}",
        doc_to_visual=doc_to_visual,
        doc_to_text=_make_doc_to_text("question"),
        doc_to_target=lambda doc: doc.get("gpt_answer", ""),
        process_results=process_results_wild,
        aggregate=aggregate,
        primary_metric="gpt_eval_llava_all",
        load_docs=_make_load("gagan3012/multilingual-llava-bench", "train",
                             subset=_lang),
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))

register_group("multilingual_llava_bench",
               [f"llava_in_the_wild_{lang}" for lang in MULTILINGUAL_LANGS])
