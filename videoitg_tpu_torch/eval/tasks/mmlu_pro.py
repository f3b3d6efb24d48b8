"""MMLU-Pro (parity: lmms_eval/tasks/mmlu_pro/_default_template_yaml +
utils.py + the 14 subject yamls).

CoT generation over TIGER-Lab/MMLU-Pro (split test, fewshot from
validation with utils.fewshot_to_text). Prompt (format_cot_example,
utils.py:23-37): "Question:\\n{q}\\nOptions:\\nA. ...\\nAnswer: Let's
think step by step." with up to 16 lettered options. Scoring: the
yaml's custom-extract regex 'answer is \\(?([ABCDEFGHIJ])\\)?' (take
first) then exact_match ignoring case and punctuation. One task per
subject (rows filtered by category, utils.py:42-43) + the mmlu_pro
group.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.tasks.text_mc import no_visual

CHOICES = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L",
           "M", "N", "O", "P"]

SUBJECTS = ("biology", "business", "chemistry", "computer_science",
            "economics", "engineering", "health", "history", "law",
            "math", "other", "philosophy", "physics", "psychology")

_EXTRACT_RE = re.compile(r"answer is \(?([ABCDEFGHIJ])\)?")


def format_cot_example(doc: dict, including_answer: bool = True) -> str:
    """utils.py:23-37."""
    prompt = "Question:\n" + doc["question"] + "\n" + "Options:\n"
    for i, opt in enumerate(doc["options"]):
        prompt += "{}. {}\n".format(CHOICES[i], opt)
    if including_answer:
        cot = doc["cot_content"].replace(
            "A: Let's think step by step.",
            "Answer: Let's think step by step.")
        prompt += cot + "\n\n"
    else:
        prompt += "Answer: Let's think step by step."
    return prompt


def doc_to_text(doc) -> str:
    return format_cot_example(doc, including_answer=False)


def fewshot_to_text(doc) -> str:
    return format_cot_example(doc, including_answer=True)


def extract_answer(response: str) -> str:
    m = _EXTRACT_RE.findall(response)
    return m[0].strip() if m else "[invalid]"


def _normalize(s: str) -> str:
    """exact_match with ignore_case + ignore_punctuation (yaml)."""
    return s.translate(str.maketrans("", "", string.punctuation)) \
        .strip().lower()


def process_results(doc, response: str) -> dict:
    pred = extract_answer(response)
    return {"question_id": doc.get("question_id"),
            "pred": pred, "answer": doc["answer"],
            "exact_match":
                float(_normalize(pred) == _normalize(doc["answer"]))}


def aggregate(records: List[dict]) -> Dict[str, float]:
    n = max(1, len(records))
    return {"exact_match": sum(r["exact_match"] for r in records) / n}


def _make_load(subject: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        docs = load_benchmark_docs("TIGER-Lab/MMLU-Pro", data_root, split)
        # per-subject yaml: process_docs filters by category
        return [d for d in docs if d.get("category") == subject]
    return load_docs


for _subject in SUBJECTS:
    register_task(Task(
        name=f"mmlu_pro_{_subject}",
        doc_to_visual=no_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc["answer"],
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="exact_match",
        load_docs=_make_load(_subject),
        doc_id_key="question_id",
        generation_kwargs={"until": ["</s>", "Q:", "<|im_end|>"],
                           "do_sample": False, "temperature": 0.0},
        # _default_template_yaml: 5-shot from validation, first_n, with
        # fewshot_to_text rendering the CoT exemplar (including_answer) and
        # an EMPTY fewshot target — the CoT already ends in "answer is (X)".
        num_fewshot=5,
        fewshot_split="validation",
        fewshot_config={"sampler": "first_n",
                        "doc_to_text": fewshot_to_text,
                        "doc_to_target": ""},
    ))

register_group("mmlu_pro", [f"mmlu_pro_{s}" for s in SUBJECTS])
