"""HallusionBench (parity: lmms_eval/tasks/hallusion_bench/
evaluate_hb.py + utils.py + hallusion_bench_image.yaml).

Yes/no visual-illusion & language-hallucination pairs over
lmms-lab/HallusionBench (split "image"). Docs carry question /
gt_answer ("0"/"1") / gt_answer_details (the reference answer text) /
category ("VD" visual-dependent | "VS" visual-supplement) /
subcategory / set_id / figure_id / question_id / visual_input / image.

Scoring parity:
1. A GPT "intelligent teacher" judgement per sample (utils.py:33-92):
   the verbatim prompt below; the reply maps "incorrect"→"0" (checked
   FIRST — "incorrect" contains "correct"), "correct"→"1", else "2"
   (unclear). The reference runs this loop inside the aggregation;
   this port runs it per-sample in process_results so shards/resume/
   cache cover it — prompt and parse are byte-identical.
2. assign_correctness (utils.py:164-171): a VS question with NO visual
   supplement (figure_id 0) counts unclear as correct (the model
   cannot know); everything else requires "1".
3. Three aggregations (evaluate_hb.py:43-75, round(100*c/t, 4)):
   * aAcc — per-question accuracy over unique (category, subcategory,
     set_id, figure_id, question_id) rows (utils.py:209-248).
   * fAcc — per-FIGURE consistency: group by (category, subcategory,
     set_id, figure_id), skipping VS figure_id 0; a figure is correct
     only when every question on it is (utils.py:174-206).
   * qAcc — per-question-PAIR consistency: group by (category,
     subcategory, set_id, question_id); correct only when the question
     is answered correctly with and without the figure edit
     (utils.py:252-306).
   The reference registers the three as separate metrics over the same
   records; this port's single aggregate returns all three keys.

The commented-out *_intern yes/no string-match variants
(evaluate_hb.py:89-136) are exposed as ``hallusion_bench_image_intern``
— judge-free, useful offline.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

# utils.py:39-46 — verbatim parity contract (incl. the curly quotes).
TEACHER_PROMPT = (
    "Imagine you are an intelligent teacher. Thoroughly read the "
    "question, reference answer and the prediction answer to ensure a "
    "clear understanding of the information provided. Assess the "
    "correctness of the predictions. "
    "If the prediction answer does not conflict with the reference "
    "answer, please generate “correct”. If the prediction "
    "answer conflict with the reference answer, please generate "
    "“incorrect”. If the prediction answer is unclear about "
    "the answer, please generate \"unclear\". \n\n Question:")


def judge_correctness(question: str, gt_details: str, pred: str,
                      judge=None) -> str:
    """utils.py:38-92 -> "1" correct / "0" incorrect / "2" unclear."""
    judge = judge or get_judge()
    prompt = (f"{TEACHER_PROMPT}{question}\nReference answer: "
              f"{gt_details}\nPrediction answer:{pred}\nOutput:")
    try:
        out = judge([{"role": "user", "content": prompt}],
                    max_tokens=16).lower()
    except Exception:
        out = "unclear"
    if "incorrect" in out:  # before "correct" — substring containment
        return "0"
    if "correct" in out:
        return "1"
    return "2"


def _is_correct(r: dict) -> int:
    """assign_correctness (utils.py:164-171)."""
    check = int(r["gpt_check"])
    if r["category"] == "VS" and int(r["figure_id"]) == 0:
        return 1 if check in (1, 2) else 0
    return 1 if check == 1 else 0


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc.get("image")
    if img is None or str(img).strip() == "":
        return None  # VS no-visual rows ship a blank image field
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def _keys(doc) -> dict:
    return {k: doc[k] for k in ("category", "subcategory", "set_id",
                                "figure_id", "question_id")}


def process_results(doc, response: str) -> dict:
    return {
        **_keys(doc),
        "visual_input": doc.get("visual_input"),
        "gt_answer": doc.get("gt_answer"),
        "model_prediction": response,
        "gpt_check": judge_correctness(doc["question"],
                                       doc["gt_answer_details"], response),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"hallusion_aAcc": 0.0}
    for r in records:
        r["correct"] = _is_correct(r)
    # aAcc: unique question rows (get_eval_all)
    rows = {}
    for r in records:
        name = "_".join([r["category"], r["subcategory"], str(r["set_id"]),
                         str(r["figure_id"]), str(r["question_id"])])
        assert name not in rows, f"duplicate sample {name}"
        rows[name] = r["correct"]
    a_total, a_correct = len(rows), sum(rows.values())
    # fAcc: per figure, VS fig-0 rows excluded (get_eval_fig)
    figs: Dict[str, list] = {}
    for r in records:
        if r["category"] == "VS" and str(r["figure_id"]) == "0":
            continue
        name = "_".join([r["category"], r["subcategory"], str(r["set_id"]),
                         str(r["figure_id"])])
        figs.setdefault(name, []).append(r["correct"])
    # qAcc: per question pair across figure variants (get_eval_pair_all)
    pairs: Dict[str, list] = {}
    for r in records:
        name = "_".join([r["category"], r["subcategory"], str(r["set_id"]),
                         str(r["question_id"])])
        pairs.setdefault(name, []).append(r["correct"])
    out = {"hallusion_aAcc": round(100.0 * a_correct / a_total, 4)}
    if figs:
        out["hallusion_fAcc"] = round(
            100.0 * sum(all(v) for v in figs.values()) / len(figs), 4)
    if pairs:
        out["hallusion_qAcc"] = round(
            100.0 * sum(all(v) for v in pairs.values()) / len(pairs), 4)
    return out


# --- judge-free yes/no variant (evaluate_hb.py:89-136) ---------------------

def process_results_intern(doc, response: str) -> dict:
    # "1" iff the response mentions yes anywhere (evaluate_hb.py:92)
    ans = "1" if response.lower().find("yes") != -1 else "0"
    return {**_keys(doc), "gt_answer": doc.get("gt_answer"),
            "hit": ans == str(doc.get("gt_answer"))}


def aggregate_intern(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"hallusion_aAcc": 0.0}
    out = {"hallusion_aAcc":
           round(100.0 * sum(r["hit"] for r in records) / len(records), 4)}
    qlist: Dict[str, list] = {}
    flist: Dict[str, list] = {}
    for r in records:
        qk = "_".join([r["category"], r["subcategory"], str(r["set_id"]),
                       str(r["question_id"])])
        fk = "_".join([r["category"], r["subcategory"], str(r["set_id"]),
                       str(r["figure_id"])])
        qlist.setdefault(qk, []).append(r["hit"])
        flist.setdefault(fk, []).append(r["hit"])
    out["hallusion_qAcc"] = round(
        100.0 * sum(min(v) for v in qlist.values()) / len(qlist), 4)
    out["hallusion_fAcc"] = round(
        100.0 * sum(min(v) for v in flist.values()) / len(flist), 4)
    return out


_GEN = {"max_new_tokens": 128, "temperature": 0, "do_sample": False}


def _load(data_root: str, split: str = "image") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/HallusionBench", data_root, split)


register_task(Task(
    name="hallusion_bench_image",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("gt_answer_details"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="hallusion_aAcc",
    load_docs=_load,
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="hallusion_bench_image_intern",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("gt_answer"),
    process_results=process_results_intern,
    aggregate=aggregate_intern,
    primary_metric="hallusion_aAcc",
    load_docs=_load,
    generation_kwargs=dict(_GEN),
))
