"""GSM8K (parity: lmms_eval/tasks/gsm8k/gsm8k.yaml — the shipped
5-shot CoT config).

Math word problems (gsm8k config main, split test; fewshot from train).
Prompt: "Question: {question}\\nAnswer:"; generation stops at the next
"Question:". Scoring reproduces the yaml's TWO filter pipelines as two
metrics over the same response (the reference registers one filter_list
with two variants; this harness's Task carries a single pipeline, so
both extractions run inside process_results — same numbers):

* exact_match,strict-match: regex "#### (\\-?[0-9\\.\\,]+)", take
  first;
* exact_match,flexible-extract: regex "(-?[$0-9.,]{2,})|(-?[0-9]+)",
  group_select -1 (the LAST number mentioned).

Both compare with HF-evaluate exact_match semantics at the yaml's
knobs: ignore_case, keep punctuation, and regexes_to_ignore
[",", "\\$", "(?s).*#### ", "\\.$"] applied to BOTH sides.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.tasks.text_mc import no_visual

STRICT_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
FLEXIBLE_RE = re.compile(r"(-?[$0-9.,]{2,})|(-?[0-9]+)")
REGEXES_TO_IGNORE = [",", r"\$", r"(?s).*#### ", r"\.$"]
INVALID = "[invalid]"


def doc_to_text(doc) -> str:
    return f"Question: {doc['question']}\nAnswer:"


def doc_to_target(doc) -> str:
    return doc["answer"]


def extract_strict(response: str) -> str:
    m = STRICT_RE.findall(response)
    return m[0].strip() if m else INVALID


def extract_flexible(response: str) -> str:
    """group_select -1: the LAST match; tuple groups pick the first
    non-empty (reference filters/extraction.py:33-76)."""
    matches = FLEXIBLE_RE.findall(response)
    if not matches:
        return INVALID
    m = matches[-1]
    if isinstance(m, tuple):
        m = next((g for g in m if g), INVALID)
    return m.strip()


def _normalize(s: str) -> str:
    """HF evaluate exact_match with the yaml's knobs: regexes_to_ignore
    stripped from both sides, then casefold."""
    for pattern in REGEXES_TO_IGNORE:
        s = re.sub(pattern, "", s)
    return s.strip().lower()


def process_results(doc, response: str) -> dict:
    gold = _normalize(doc["answer"])
    return {
        "question": doc["question"],
        "strict": float(_normalize(extract_strict(response)) == gold),
        "flexible": float(_normalize(extract_flexible(response)) == gold),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    n = max(1, len(records))
    return {
        "exact_match,strict-match":
            sum(r["strict"] for r in records) / n,
        "exact_match,flexible-extract":
            sum(r["flexible"] for r in records) / n,
    }


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("gsm8k", data_root, split, subset="main")


register_task(Task(
    name="gsm8k",
    doc_to_visual=no_visual,
    doc_to_text=doc_to_text,
    doc_to_target=doc_to_target,
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="exact_match,strict-match",
    load_docs=load_docs,
    generation_kwargs={"until": ["Question:", "</s>", "<|im_end|>"],
                       "do_sample": False, "temperature": 0.0},
    # gsm8k.yaml:30-31: num_fewshot 5, fewshot_split train. Exemplars
    # render doc_to_text + " " + the gold answer (incl. its CoT and the
    # "#### N" line) — the default sampler rendering.
    num_fewshot=5,
    fewshot_split="train",
))
