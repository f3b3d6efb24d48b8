"""LiveBench (parity: lmms_eval/tasks/live_bench/utils.py [v1 template,
tasks 2406/2407] + utils_v2.py [2409] + live_bench.yaml +
live_bench_template_yaml{,_v2}).

Monthly-refreshed news-image QA (lmms-lab/LiveBench, configs 2024-06 /
2024-07 / 2024-09, split test). The model answers doc["question"] over
doc["images"]; a judge rates the answer 0-10 against doc["answer"]
under doc["criteria"], with ALL images attached to the judge call and a
JSON {"Explanation", "Rating"} response contract (utils.py:48-132).
Differences between the two template generations, both preserved:

* v1 (2406/2407): prompt includes the political-refusal scoring clause
  (utils.py:71); SUBTASKS are the five Understanding/Implications
  buckets (utils.py:159), unknown subtasks coerced to "further
  insights" (utils.py:166-167 — lowercase, sic).
* v2 (2409): prompt drops the political clause; SUBTASKS are the four
  Recognition/Assistance buckets (utils_v2.py:157), unknown subtasks
  keep their raw name.

Scoring (both): empty model response -> rating 0 "No response"; judge
failure -> rating -1, EXCLUDED from aggregation. Aggregate
(utils.py:192-214): mean(rating/10)*100 over rated docs, plus
per-subtask means. The reference's v1 aggregator KeyErrors on coerced
unknown subtasks (it appends under the RAW name into a dict keyed by
SUBTASKS — utils.py:205); here unknown subtasks aggregate under their
stored (coerced) name instead of crashing — documented divergence.
EVAL_WITH_MINI is false in the shipped yaml, so only gpt4_eval_score is
produced (utils.py:185-189).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.llava_bench import _b64

# utils.py:48-80 — verbatim v1 prompt (format args: prompt/generation/
# reference/criteria).
_PROMPT_V1 = """\
[Question]

{prompt}

[Assistant Response]

{generation}

[Ground Truth Response]

{reference}

[System]

Rate whether the assistant response correctly matches the ground truth, in regards to the image above.

The rating should be 0-10, where 0 is incorrect and 10 is correct.

Below is the specific criteria for rating:

{criteria}

Total score is out of 10. If the model's answer cannot be provided due to political reasons, please assign a score of 0 for further processing. If the model's response is biased due to political factors, please score it based on its understanding of the image, but reduce the objectivity score accordingly.

Your response should be in the JSON format:
```json
{{
    "Explanation": "(your explanation)",
    "Rating": "(int)"
}}
```
"""

# utils_v2.py:51-81 — v2 drops the political clause.
_PROMPT_V2 = """\
[Question]

{prompt}

[Assistant Response]

{generation}

[Ground Truth Response]

{reference}

[System]

Rate whether the assistant response correctly matches the ground truth, in regards to the image above.

The rating should be 0-10, where 0 is incorrect and 10 is correct.

Below is the specific criteria for rating:

{criteria}

Your response should be in the JSON format:
```json
{{
    "Explanation": "(your explanation)",
    "Rating": "(int)"
}}
```
"""

SUBTASKS_V1 = ("Basic Understanding", "Contextual Analysis",
               "Deeper Implications", "Broader Implications",
               "Further Insights")
SUBTASKS_V2 = ("Concrete Recognition", "Analytical Questions",
               "Divergent Thinking", "Real-world Assistance")

_JSON_BLOCK_RE = re.compile(r"\{.*\}", re.S)


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:146-148."""
    return list(doc["images"])


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    """utils.py:151-156."""
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def _judge_rating(doc, response: str, template: str):
    """utils.py:87-132 / utils_v2.py:93-132: judge with images attached,
    JSON response parsed; any failure -> (-1, explanation)."""
    prompt = template.format(prompt=doc["question"], generation=response,
                             reference=doc["answer"],
                             criteria=doc["criteria"])
    parts = []
    for img in doc_to_visual(doc):
        b64 = _b64(img)
        if b64:
            parts.append({"type": "image_url",
                          "image_url":
                              {"url": f"data:image/jpeg;base64,{b64}"}})
    parts.append({"type": "text", "text": prompt})
    try:
        review = get_judge()([{"role": "user", "content": parts}],
                             max_tokens=1024)
        m = _JSON_BLOCK_RE.search(review)
        data = json.loads(m.group(0) if m else review)
        return int(data["Rating"]), str(data.get("Explanation", ""))
    except Exception as e:
        return -1, str(e)


def _make_process(template: str, subtasks: tuple, coerce_unknown: bool):
    def process_results(doc, response: str) -> dict:
        subtask = doc["subtask"]
        if coerce_unknown and subtask not in subtasks:
            subtask = "further insights"  # utils.py:166-167, sic
        if not response:
            return {"rating": 0, "explanation": "No response",
                    "subtask": subtask, "id": doc.get("id")}
        rating, explanation = _judge_rating(doc, response, template)
        return {"rating": rating, "explanation": explanation,
                "subtask": subtask, "id": doc.get("id")}
    return process_results


def _make_aggregate(subtasks: tuple):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        """utils.py:192-214."""
        total, count = 0.0, 0
        by_sub: Dict[str, list] = {s: [] for s in subtasks}
        for r in records:
            if r["rating"] == -1:
                continue
            total += r["rating"] / 10
            count += 1
            by_sub.setdefault(r["subtask"], []).append(r["rating"] / 10)
        out = {"gpt4_eval_score": total / count * 100 if count else 0.0}
        for s, vals in by_sub.items():
            if vals:
                key = "livebench_" + s.lower().replace(" ", "_")
                out[key] = sum(vals) / len(vals) * 100
        return out
    return aggregate


def _make_load(config: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/LiveBench", data_root, split,
                                   subset=config)
    return load_docs


_GEN = {"max_new_tokens": 1024, "temperature": 0, "top_p": 1.0,
        "do_sample": False}

for _name, _config, _tmpl, _subs, _coerce in (
        ("live_bench_2406", "2024-06", _PROMPT_V1, SUBTASKS_V1, True),
        ("live_bench_2407", "2024-07", _PROMPT_V1, SUBTASKS_V1, True),
        ("live_bench_2409", "2024-09", _PROMPT_V2, SUBTASKS_V2, False)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answer", ""),
        process_results=_make_process(_tmpl, _subs, _coerce),
        aggregate=_make_aggregate(_subs),
        primary_metric="gpt4_eval_score",
        load_docs=_make_load(_config),
        generation_kwargs=dict(_GEN),
        prompt_overrides={"default": {"pre_prompt": "", "post_prompt": ""}},
    ))

register_group("live_bench", ["live_bench_2406", "live_bench_2407",
                              "live_bench_2409"])
