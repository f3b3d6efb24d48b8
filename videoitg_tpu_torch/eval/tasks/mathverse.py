"""MathVerse (parity: lmms_eval/tasks/mathverse/utils.py +
mathverse_evals.py + the 7 task yamls; group mathverse.yaml).

Seven tasks over CaraJ/MathVerse-lmmseval: ``mathverse_testmini`` (the
full testmini config) plus six problem-version splits — text_only (no
image: doc_to_visual returns nothing when the image field is blank,
utils.py:26-29), text_lite, text_dominant, vision_intensive,
vision_dominant, vision_only (dataset config testmini_version_split,
per-yaml test_split).

Docs carry sample_index / problem_index / problem_version / question /
answer / question_type ("multi-choice"/"free-form") / query_wo /
query_cot / metadata {split, subfield} / image.

Pipeline parity:
1. doc_to_text = create_one_query (mathverse_evals.py:236-292). Every
   vendored yaml uses shot_type "format-prompt" + query_type "query_wo"
   (mathverse_testmini.yaml:29-32), which reduces to the dataset's
   prebuilt query_wo string; "custom-prompt" (hint dict keyed by
   question type, "Question: ..." text) and query_cot are supported as
   prompt_overrides for parity with the yaml comment.
2. Scoring is a TWO-call GPT protocol (mathverse_evals.py:296-323
   eval_results): (a) truncate the prediction to its last
   trunk_response=30 whitespace-split words (mathverse.yaml metadata),
   (b) extract the final answer with DEMO_PROMPT_EXTRACT, (c) judge
   consistency against the gold with DEMO_PROMPT_SCORE, whose reply is
   parsed as a bare 0/1 Judgement. The reference runs both calls at
   aggregation time in one big loop; this port runs them per-sample in
   process_results so per-rank shards, resume, and the response cache
   cover the judged values — the prompts and the 0/1 parse are
   byte-identical. quick_match (extraction == answer) mirrors the
   config flag.
3. Aggregation (eval_results tail): average accuracy = 100*correct/
   total rounded to 2, plus problem_version and subfield rollups.

The offline exact-match judge answers both prompt shapes
deterministically (judge.py: _mathverse_extract / _consistency);
divergence from GPT judging is documented there — use http:/hf: for
reference-comparable numbers.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

# mathverse_evals.py:9-38 — verbatim parity contract (the extraction
# judge instruction; a changed word changes the metric).
DEMO_PROMPT_EXTRACT = """
I am providing you a response from a model to a math problem, termed 'Model Response'. You should extract the answer from the response as 'Extracted Answer'. Directly output the extracted answer with no explanation.

1.
Model response: 'Rounded to two decimal places, the perimeter of the sector is approximately:\n\n(-2, 1)'
Extracted Answer: (-2, 1)

2.
Model response: 'at those points.\n\nTherefore, the correct option that represents the meaning of the intersection points of the graphs is:\n\nD. They give the solutions to the equation $f(t)=g(t)$.",'
Extracted Answer: D

3.
Model response: ' at 1 (there's a closed circle at y = 1), the range in interval notation is \\((-4, 1]\\).\n\nFinal values:\nDomain: \\((-3, 3]\\)\nRange: \\((-4, 1]\\)'
Extracted Answer: Domain: \\((-3, 3]\\)\nRange: \\((-4, 1]\\)

4.
Model response: 'As it stands, I cannot provide the correct option letter because there isn't enough information to solve for 'y'.'
Extracted Answer: null

5.
Model response: 'Given that AB = 17.6 meters, we can now substitute into the equation:\n\nd = 17.6 / cos(38\u00b0)\n\nTherefore, to one decimal place, the distance d between Ned and Bart is approximately 22.3 meters.'
Extracted answer: 22.3

6.
Model response:  have all the coefficients for the quadratic function:\n\\( f(x) = ax^2 + bx + c \\)\n\\( f(x) = -1x^2 - 2x + 1 \\)\n\nTherefore, the equation for the graphed function \\( f \\) is:\n\\( f(x) = -x^2 - 2x + 1 \\)"'
Extracted answer: f(x) = -x^2 - 2x + 1

7.
"""

# mathverse_evals.py:41-75 — verbatim parity contract (the consistency
# judge instruction, {question}/{gt}/{extraction} format slots).
DEMO_PROMPT_SCORE = """
Below are two answers to a math question. Question is [Question], [Standard Answer] is the standard answer to the question, and [Model_answer] is the answer extracted from a model's output to this question.  Determine whether these two answers are consistent.
Please note that only when the [Model_answer] completely matches the [Standard Answer] means they are consistent. For non-multiple-choice questions, if the meaning is expressed in the same way, it is also considered consistent, for example, 0.5m and 50cm.
If they are consistent, Judement is 1; if they are different, Judement is 0.

[Question]: Write the set of numbers represented on the number line in interval notation.
[Standard Answer]: (-2,1]
[Model_answer] : Extracted Answer: \\((-2, 1)\\)
Judgement: 0

[Question]: As shown in the figure, circle O has a radius 1.0, if angle BAC = 60.0, then the length of BC is ()\nChoices:\nA:2\nB:2\u221a{{3}}\nC:\u221a{{3}}\nD:2\u221a{{2}}
[Standard Answer]: C
[Model_answer] : B:2\u221a{{3}}
Judgement: 0

[Question]: Find the domain and range of the function f using interval notation.
[Standard Answer]: domain: [-4, 0) and range: (-3, 1]
[Model_answer] : Range: \\((-4, 1]\\)
Judgement: 0

[Question]: As shown in the figure, circle O has a radius 1.0, if angle BAC = 60.0, then the length of BC is ()\nChoices:\nA:2\nB:2\u221a{{3}}\nC:\u221a{{3}}\nD:2\u221a{{2}}
[Standard Answer]: C
[Model_answer] : null
Judgement: 0

[Question]: Given the graph of the ellipse that intersects with x-axis at 9 and -9 and with y-axis at 3 and -3, determine its equation.A. \\frac{{x^2}}{{81}} + \\frac{{y^2}}{{9}} = 1 B. Can not determine.\n
[Standard Answer]: A
[Model_answer] : \\frac{{x^2}}{{81}} + \\frac{{y^2}}{{9}} = 1
Judgement: 1

[Question]: {question}
[Standard Answer]: {gt}
[Model_answer] : {extraction}
Judgement: """

TRUNK_RESPONSE = 30  # mathverse.yaml metadata: trunk_response


def create_one_query(problem: dict, shot_type: str = "format-prompt",
                     hint: dict | None = None,
                     query_type: str = "query_wo") -> str:
    """mathverse_evals.py:236-292 at shot_num=0 (every vendored yaml;
    the few-shot demo path is dead upstream — examples=None)."""
    if shot_type == "format-prompt":
        hint_text = ""
        question_text = str(problem[query_type])
    elif shot_type == "custom-prompt":
        key = ("multi-choice" if problem["question_type"] == "multi-choice"
               else "free-form")
        hint_text = (hint or {})[key]
        question_text = f"Question: {problem['question']}"
    else:
        raise ValueError(f"unsupported shot_type {shot_type!r} "
                         "(mathverse_testmini.yaml:30 allows format-prompt "
                         "or custom-prompt)")
    return "\n".join(e for e in (hint_text, question_text)
                     if e != "").strip()


def extract_answer(response: str, judge=None) -> str:
    """mathverse_evals.py:190-203 — single LLM extraction call."""
    if not response:
        return ""
    judge = judge or get_judge()
    full_prompt = (f"{DEMO_PROMPT_EXTRACT.strip()}\n\n"
                   f"Model response: '{response}'\nExtracted Answer: ")
    try:
        return judge([{"role": "user", "content": full_prompt}],
                     max_tokens=256)
    except Exception:
        return ""


def score_answer(question: str, answer: str, extraction: str,
                 quick_match: bool = False, judge=None) -> bool:
    """mathverse_evals.py:205-221 — 0/1 consistency judgement."""
    if quick_match:
        return extraction == answer
    judge = judge or get_judge()
    full_prompt = DEMO_PROMPT_SCORE.strip().format(
        question=question, gt=answer, extraction=extraction)
    try:
        reply = judge([{"role": "user", "content": full_prompt}],
                      max_tokens=8)
        judgement = reply.replace("Judgement:", "").strip()
        # the reference loops until the reply is a bare 0/1; a judge that
        # never produces one would spin forever, so non-binary replies
        # score 0 here (fail-closed) instead
        return judgement == "1"
    except Exception:
        return False


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc.get("image")
    if img is None or str(img).strip() == "":
        return None  # text_only split (utils.py:26-29 returns [])
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, shot_type: str = "format-prompt", hint=None,
                query_type: str = "query_wo") -> str:
    problem = {
        "question": doc["question"],
        "query_wo": doc["query_wo"],
        "query_cot": doc["query_cot"],
        "question_type": doc["question_type"],
    }
    return create_one_query(problem, shot_type=shot_type, hint=hint,
                            query_type=query_type)


def process_results(doc, response: str) -> dict:
    full_prediction = response.strip()
    # trunk_response: keep the LAST 30 whitespace-split words
    # (mathverse_evals.py:301-304)
    prediction = " ".join(full_prediction.split(" ")[-TRUNK_RESPONSE:])
    extraction = extract_answer(prediction)
    answer = doc.get("answer")
    true_false = (score_answer(doc["question"], answer, extraction)
                  if answer is not None else False)
    meta = doc.get("metadata") or {}
    return {
        "question_id": doc["sample_index"],
        "problem_index": doc.get("problem_index"),
        "problem_version": doc.get("problem_version"),
        "answer": answer,
        "extraction": extraction,
        "prediction": prediction,
        "true_false": true_false,
        "question_type": doc["question_type"],
        "subfield": meta.get("subfield"),
    }


def _rollup(records: List[dict], key: str) -> Dict[str, float]:
    out = {}
    for v in sorted({r[key] for r in records if r.get(key) is not None}):
        sub = [r for r in records if r.get(key) == v]
        slug = re.sub(r"\W+", "_", str(v).lower()).strip("_")
        out[f"mathverse_{key}_{slug}"] = round(
            100.0 * sum(r["true_false"] for r in sub) / len(sub), 2)
    return out


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"mathverse_accuracy": 0.0}
    out = {"mathverse_accuracy":
           round(100.0 * sum(r["true_false"] for r in records)
                 / len(records), 2)}
    for key in ("problem_version", "subfield"):  # eval_results target_keys
        out.update(_rollup(records, key))
    return out


_GEN = {"max_new_tokens": 1024, "temperature": 0, "do_sample": False,
        "until": ["ASSISTANT:"]}

# (task suffix, dataset config, split) per the seven yamls
_SPLITS = (
    ("", "testmini", "testmini"),
    ("_text_only", "testmini_text_only", "text_only"),
    ("_text_lite", "testmini_version_split", "text_lite"),
    ("_text_dominant", "testmini_version_split", "text_dominant"),
    ("_vision_intensive", "testmini_version_split", "vision_intensive"),
    ("_vision_dominant", "testmini_version_split", "vision_dominant"),
    ("_vision_only", "testmini_version_split", "vision_only"),
)


def _make_load_docs(config: str, default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("CaraJ/MathVerse-lmmseval", data_root,
                                   split, subset=config)
    return load_docs


for _suffix, _config, _split in _SPLITS:
    register_task(Task(
        name=f"mathverse_testmini{_suffix}",
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get("answer"),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="mathverse_accuracy",
        load_docs=_make_load_docs(_config, _split),
        doc_id_key="sample_index",
        generation_kwargs=dict(_GEN),
    ))
