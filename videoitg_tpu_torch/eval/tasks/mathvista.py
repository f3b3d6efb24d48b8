"""MathVista (parity: lmms_eval/tasks/mathvista/utils.py +
mathvista_evals.py + mathvista_testmini_{cot,solution,format}.yaml,
mathvista_test.yaml).

Image task: docs carry pid / question / query (the dataset's prebuilt
query string, used as the extraction-prompt context,
utils.py:70-80) / choices / unit / precision / answer (withheld on
test) / question_type ("multi_choice" or "free_form") / answer_type
("text"/"integer"/"float"/"list") / metadata (language/source/category/
task/context/grade/skills) / image.

Pipeline parity:
1. doc_to_text builds the query via create_one_query
   (mathvista_evals.py:600-780) — hint text by shot_type x answer_type,
   "(Unit: ...)" suffix, lettered choices ("(A) x" normally, "A. x" for
   format-prompt), trailing "Solution: "/"Python code: " cue. All
   vendored yamls use shot: 0 / use_caption: False / use_ocr: False;
   the 3-example few-shot demo bank is deliberately unported (shot > 0
   raises).
2. extract_answer (mathvista_evals.py:232-277): direct type parses
   (multi-choice membership, int(), float()), optional quick-extract
   regex 'The answer is "(.*)".', then an LLM extraction call with the
   DEMO_PROMPT — routed through eval/judge.get_judge() (the reference
   posts to the OpenAI API; the offline exact-match judge has a
   deterministic last-token heuristic stand-in, divergence documented
   in judge.py).
3. normalize_extracted_answer (mathvista_evals.py:285-330): "(A)"
   letter pull, option-letter -> choice text, else Levenshtein
   most-similar choice; int/float/list casts (float rounds to
   doc precision).
4. safe_equal string compare (mathvista_evals.py:332-341).

Aggregation: average accuracy = 100 * correct/total rounded to 2
(utils.py:105-112) as the headline, plus question_type / answer_type /
task rollups (get_acc_with_contion). The reference's full scores dict
(language/source/.../skills splits) is recoverable from samples.jsonl,
which carries every rollup key per record.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.metrics import levenshtein_distance

# mathvista_evals.py:115-140 — verbatim parity contract: this prompt IS
# the extraction-judge instruction; a changed word changes the metric.
DEMO_PROMPT = """
Please read the following example. Then extract the answer from the model response and type it at the end of the prompt.

Hint: Please answer the question requiring an integer answer and provide the final value, e.g., 1, 2, 3, at the end.
Question: Which number is missing?

Model response: The number missing in the sequence is 14.

Extracted answer: 14

Hint: Please answer the question requiring a floating-point number with one decimal place and provide the final value, e.g., 1.2, 1.3, 1.4, at the end.
Question: What is the fraction of females facing the camera?

Model response: The fraction of females facing the camera is 0.6, which means that six out of ten females in the group are facing the camera.

Extracted answer: 0.6

Hint: Please answer the question requiring a floating-point number with two decimal places and provide the final value, e.g., 1.23, 1.34, 1.45, at the end.
Question: How much money does Luca need to buy a sour apple candy and a butterscotch candy? (Unit: $)

Model response: Luca needs $1.45 to buy a sour apple candy and a butterscotch candy.

Extracted answer: 1.45

Hint: Please answer the question requiring a Python list as an answer and provide the final list, e.g., [1, 2, 3], [1.2, 1.3, 1.4], at the end.
Question: Between which two years does the line  graph saw its maximum peak?

Model response: The line graph saw its maximum peak between 2007 and 2008.

Extracted answer: [2007, 2008]

Hint: Please answer the question and provide the correct option letter, e.g., A, B, C, D, at the end.
Question: What fraction of the shape is blue?\\nChoices:\\n(A) 3/11\\n(B) 8/11\\n(C) 6/11\\n(D) 3/5

Model response: The correct answer is (B) 8/11.

Extracted answer: B
"""

# Hint text per (shot_type, slot) — mathvista_evals.py:436-515. Slots:
# mc = multi_choice, int / f1 / f2 = integer / float p1 / float p2, list.
_HINTS = {
    "solution": {
        "mc": ("Hint: Please answer the question and provide the correct "
               "option letter, e.g., A, B, C, D, at the end."),
        "int": ("Hint: Please answer the question requiring an integer "
                "answer and provide the final value, e.g., 1, 2, 3, at "
                "the end."),
        "f1": ("Hint: Please answer the question requiring a "
               "floating-point number with one decimal place and provide "
               "the final value, e.g., 1.2, 1.3, 1.4, at the end."),
        "f2": ("Hint: Please answer the question requiring a "
               "floating-point number with two decimal places and provide "
               "the final value, e.g., 1.23, 1.34, 1.45, at the end."),
        "list": ("Hint: Please answer the question requiring a Python "
                 "list as an answer and provide the final list, e.g., "
                 "[1, 2, 3], [1.2, 1.3, 1.4], at the end."),
    },
    "format-prompt": {
        "mc": "Answer with the option's letter from the given choices "
              "directly.",
        "int": "Answer the question using a single integer number.",
        "f1": ("Answer the question using a single floating-point number "
               "with one decimal place."),
        "f2": ("Answer the question using a single floating-point number "
               "with two decimal places."),
        "list": "Answer the question using a Python list.",
    },
    "reason-first": {
        "mc": ("First perform reasoning, then finally select the question "
               "from the choices in the following format: Answer: xxx."),
        "int": ("First perform reasoning, then finally answer the "
                "question requiring an integer answer and provide the "
                "final value, e.g., 1, 2, 3, at the end in the following "
                "format: Answer: xxx."),
        "f1": ("First perform reasoning, then finally answer the question "
               "requiring a floating-point number with one decimal place "
               "and provide the final value, e.g., 1.2, 1.3, 1.4, at the "
               "end in the following format: Answer: xxx."),
        "f2": ("First perform reasoning, then finally answer the question "
               "requiring a floating-point number with two decimal places "
               "and provide the final value, e.g., 1.23, 1.34, 1.45, at "
               "the end in the following format: Answer: xxx."),
        "list": ("First perform reasoning, then finally answer the "
                 "question requiring a Python list as an answer and "
                 "provide the final list, e.g., [1, 2, 3], [1.2, 1.3, "
                 "1.4], at the end in the following format: Answer: xxx."),
    },
}
# step-by-step shares solution's hints (mathvista_evals.py:471-488)
_HINTS["step-by-step"] = _HINTS["solution"]


def _hint_slot(question_type: str, answer_type: str, precision) -> str:
    if question_type == "multi_choice":
        return "mc"
    if answer_type == "integer":
        return "int"
    if answer_type == "float":
        return "f2" if precision == 2 else "f1"
    return "list"


def create_one_query(problem: dict, shot_type: str,
                     use_caption: bool = False,
                     use_ocr: bool = False, shot_num: int = 0) -> str:
    """mathvista_evals.py:600-780 at shot_num=0 (every vendored yaml)."""
    if shot_num:
        raise NotImplementedError(
            "few-shot demo bank unported: all reference mathvista yamls "
            "use shot: 0 (mathvista_testmini_*.yaml:25)")
    question_type = problem["question_type"]
    answer_type = problem["answer_type"]
    precision = problem.get("precision", 0)

    if shot_type == "direct":
        hint_text = ""
    elif shot_type == "code":
        hint_text = "Hint: Please generate a python code to solve the problem"
    else:
        hint_text = _HINTS[shot_type][_hint_slot(question_type, answer_type,
                                                 precision)]

    question_text = (problem["question"] if shot_type == "format-prompt"
                     else f"Question: {problem['question']}")
    if problem.get("unit"):
        question_text += f" (Unit: {problem['unit']})"

    choices = problem.get("choices") or []
    if choices:
        if shot_type == "format-prompt":
            choices_text = "\n".join(
                f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(choices))
        else:
            choices_text = "\n".join(
                ["Choices:"] + [f"({chr(ord('A') + i)}) {c}"
                                for i, c in enumerate(choices)])
    else:
        choices_text = ""

    caption_text = (f"Image description: {problem['caption']}"
                    if use_caption and problem.get("caption") else "")
    ocr_text = (f"Image detected text: {problem['ocr']}"
                if use_ocr and problem.get("ocr") else "")
    prompt = {"solution": "Solution: ", "code": "Python code: "}.get(
        shot_type, "")

    if shot_type == "reason-first":
        elements = [hint_text, question_text, choices_text, caption_text,
                    ocr_text, prompt]
    else:
        elements = [question_text, choices_text, caption_text, ocr_text,
                    hint_text, prompt]
    return "\n".join(e for e in elements if e != "").strip()


def extract_answer(response: str, problem: dict,
                   quick_extract: bool = False, judge=None) -> str:
    """mathvista_evals.py:232-277."""
    if not response:
        return ""
    choices = problem.get("choices") or []
    if problem["question_type"] == "multi_choice" and response in choices:
        return response
    if problem["answer_type"] == "integer":
        try:
            return str(int(response))
        except ValueError:
            pass
    if problem["answer_type"] == "float":
        try:
            return str(float(response))
        except ValueError:
            pass
    if quick_extract:
        m = re.search(r'The answer is "(.*)"\.', response)
        if m:
            return m.group(1)
    judge = judge or get_judge()
    full_prompt = (f"{DEMO_PROMPT.strip()}\n\n{problem['query']}\n\n"
                   f"{response}\n\nExtracted answer: ")
    try:
        return judge([{"role": "user", "content": full_prompt}],
                     max_tokens=256)
    except Exception:
        return ""


def get_most_similar(prediction: str, choices: List[str]) -> str:
    """mathvista_evals.py:280-286 — min edit distance, first tie wins."""
    distances = [levenshtein_distance(prediction, c) for c in choices]
    return choices[distances.index(min(distances))]


def normalize_extracted_answer(extraction, choices: List[str],
                               question_type: str, answer_type: str,
                               precision) -> Optional[str]:
    """mathvista_evals.py:288-330."""
    if question_type == "multi_choice":
        extraction = (extraction.strip() if isinstance(extraction, str)
                      else str(extraction))
        letter = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letter:
            extraction = letter[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices))]
        if extraction in options:
            extraction = choices[options.index(extraction)]
        else:
            extraction = get_most_similar(extraction, choices)
        return extraction
    if answer_type == "integer":
        try:
            return str(int(float(extraction)))
        except (TypeError, ValueError):
            return None
    if answer_type == "float":
        try:
            return str(round(float(extraction), precision))
        except (TypeError, ValueError):
            return None
    if answer_type == "list":
        return str(extraction)
    return extraction


def safe_equal(prediction, answer) -> bool:
    """mathvista_evals.py:332-341."""
    try:
        return str(prediction).strip() == str(answer).strip()
    except Exception:
        return False


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def _make_doc_to_text(shot_type: str):
    def doc_to_text(doc, shot_type: str = shot_type,
                    use_caption: bool = False, use_ocr: bool = False) -> str:
        return create_one_query(doc, shot_type, use_caption=use_caption,
                                use_ocr=use_ocr)
    return doc_to_text


def process_results(doc, response: str) -> dict:
    problem = {
        "question_type": doc["question_type"],
        "answer_type": doc["answer_type"],
        "query": doc["query"],
        "choices": doc.get("choices") or [],
    }
    extraction = extract_answer(response.strip(), problem)
    prediction = normalize_extracted_answer(
        extraction, problem["choices"], doc["question_type"],
        doc["answer_type"], doc.get("precision", 0))
    answer = doc.get("answer")
    meta = doc.get("metadata") or {}
    return {
        "question_id": doc["pid"],
        "extraction": extraction,
        "prediction": prediction,
        "answer": answer,
        "true_false": (safe_equal(prediction, answer)
                       if answer is not None else False),
        "question_type": doc["question_type"],
        "answer_type": doc["answer_type"],
        # rollup keys (utils.py:118-126 target_keys) for samples.jsonl
        **{k: meta.get(k) for k in ("language", "source", "category",
                                    "task", "context", "grade", "skills")},
    }


def _rollup(records: List[dict], key: str) -> Dict[str, float]:
    out = {}
    values = sorted({r[key] for r in records if r.get(key) is not None})
    for v in values:
        sub = [r for r in records if r.get(key) == v]
        slug = re.sub(r"\W+", "_", str(v).lower()).strip("_")
        out[f"mathvista_{key}_{slug}"] = round(
            100.0 * sum(r["true_false"] for r in sub) / len(sub), 2)
    return out


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"mathvista_accuracy": 0.0}
    out = {"mathvista_accuracy":
           round(100.0 * sum(r["true_false"] for r in records)
                 / len(records), 2)}
    for key in ("question_type", "answer_type", "task"):
        out.update(_rollup(records, key))
    return out


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    # mathvista_test answers are withheld (utils.py:84 sets answer None);
    # per-sample rows (pid + extraction + normalized prediction) are the
    # scores-file deliverable.
    return {"submission_rows": float(len(records))}


def _make_load_docs(default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("AI4Math/MathVista", data_root, split)
    return load_docs


_GEN = {"max_new_tokens": 1024, "temperature": 0, "do_sample": False}

for _suffix, _shot_type in (("cot", "step-by-step"),
                            ("solution", "solution"),
                            ("format", "format-prompt")):
    register_task(Task(
        name=f"mathvista_testmini_{_suffix}",
        doc_to_visual=doc_to_visual,
        doc_to_text=_make_doc_to_text(_shot_type),
        doc_to_target=lambda doc: doc.get("answer"),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="mathvista_accuracy",
        load_docs=_make_load_docs("testmini"),
        doc_id_key="pid",
        generation_kwargs=dict(_GEN),
        # mathvista_testmini_*.yaml lmms_eval_specific_kwargs: phi3v
        # always evaluates with the solution-style prompt.
        prompt_overrides={"phi3v": {"shot_type": "solution"}},
    ))

register_task(Task(
    name="mathvista_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=_make_doc_to_text("reason-first"),
    process_results=process_results,
    aggregate=_aggregate_submission,
    load_docs=_make_load_docs("test"),
    doc_id_key="pid",
    generation_kwargs=dict(_GEN),
))
