"""WildVision-Bench (parity: lmms_eval/tasks/wild_vision_bench/
utils.py + _default_template_yaml + the 0617/0630 yamls).

Arena-style pairwise eval over WildVision/wildvision-arena-data:
``wildvision_0617`` / ``wildvision_0630`` (dataset configs
release_bench_{0617,0630}_with_modelresponse, split test500). Docs
carry instruction / image / the baseline model's stored answer under
the key "claude-3-sonnet-20240229" (BASELINE_MODEL_NAME).

Parity:
* The judge sees the verbatim arena system prompt (utils.py:50-72,
  verdict labels [[A>>B]]..[[B>>A]]) and the user template
  "<|User Prompt|>...<|The Start of Assistant A's Answer|>..." with
  A = baseline answer, B = the model's (utils.py:74), plus the image
  (vision part list — flattened to text by offline judges).
* Verdict parsing (utils.py:126-136 + 152-186): the [[...]] pattern's
  unique match, mapped in the reference's branch order to a raw score
  in {-2,-1,0,1,2}, winner, judgement label (no substring hazard:
  "A>B" is not a substring of "A>>B").
* Aggregations: raw_scores mean; win_rates = share of model_b wins *
  100; judgement-share percentages; elo_scores — the reference fits a
  2-model no-intercept LogisticRegression over duplicated battles
  (ties count once as an A-win) and reports the predicted win rate of
  the evaluation model vs the anchored baseline
  (utils.py:248-320). For two models that MLE has the closed form
  sigmoid(logit(p)) = p with p = (wins_a + ties/2)/n, so the reported
  number is exactly (wins_b + ties/2)/n * 100 — computed directly
  here (no sklearn), with saturation at 0/100 where the regression
  would diverge.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

BASELINE_MODEL_NAME = "claude-3-sonnet-20240229"

# utils.py:50-72 — verbatim parity contract.
SYSTEM_PROMPT = """\
Please act as an impartial judge and evaluate the quality of the responses provided by two AI assistants to the user prompt displayed below. You will be given assistant A's answer and assistant B's answer. Your job is to evaluate which assistant's answer is better.

Begin your evaluation by generating your own answer to the prompt. You must provide your answers before judging any answers.

When evaluating the assistants' answers, compare both assistants' answers with your answer. You must identify and correct any mistakes or inaccurate information.

Then consider if the assistant's answers are helpful, relevant, and concise. Helpful means the answer correctly responds to the prompt or follows the instructions. Note when user prompt has any ambiguity or more than one interpretation, it is more helpful and appropriate to ask for clarifications or more information from the user than providing an answer based on assumptions. Relevant means all parts of the response closely connect or are appropriate to what is being asked. Concise means the response is clear and not verbose or excessive.

Then consider the creativity and novelty of the assistant's answers when needed. Finally, identify any missing important information in the assistants' answers that would be beneficial to include when responding to the user prompt.

After providing your explanation, you must output only one of the following choices as your final verdict with a label:

1. Assistant A is significantly better: [[A>>B]]
2. Assistant A is slightly better: [[A>B]]
3. Tie, relatively the same: [[A=B]]
4. Assistant B is slightly better: [[B>A]]
5. Assistant B is significantly better: [[B>>A]]

Example output: "My final verdict is tie: [[A=B]]".\
"""

PROMPT_TEMPLATE = ("<|User Prompt|>\n{question_1}\n\n<|The Start of "
                   "Assistant A's Answer|>\n{answer_1}\n<|The End of "
                   "Assistant A's Answer|>\n\n<|The Start of Assistant "
                   "B's Answer|>\n{answer_2}\n<|The End of Assistant B's "
                   "Answer|>")

_VERDICT_RE = re.compile(r"\[\[([AB<>=]+)\]\]")


def get_score(judgement: str):
    """utils.py:126-136 — the unique [[...]] match, else None."""
    matches = [m for m in _VERDICT_RE.findall(judgement) if m != ""]
    if len(set(matches)) == 0:
        return None, True
    if len(set(matches)) == 1:
        return matches[0].strip("\n"), False
    return None, False


def classify_verdict(score: str):
    """utils.py:157-183 — checked in source order ('A>B' is NOT a
    substring of 'A>>B', so the order is safe)."""
    if "A>B" in score:
        return -1, "model_a", "Worse"
    if "A>>B" in score:
        return -2, "model_a", "Worse++"
    if "A=B" in score:
        return 0, "tie", "Tie"
    if "B>A" in score:
        return 1, "model_b", "Better"
    if "B>>A" in score:
        return 2, "model_b", "Better++"
    return 0, "tie", "Unclear"


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    q = doc["instruction"].strip()
    if pre_prompt:
        q = f"{pre_prompt}{q}"
    if post_prompt:
        q = f"{q}{post_prompt}"
    return q


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    user_prompt = PROMPT_TEMPLATE.format(
        question_1=doc["instruction"],
        answer_1=doc[BASELINE_MODEL_NAME], answer_2=response)
    parts = [{"type": "text", "text": user_prompt}]
    img = doc.get("image")
    if hasattr(img, "save"):
        import base64
        import io

        buf = io.BytesIO()
        img.save(buf, format="PNG")
        parts.append({"type": "image_url", "image_url": {
            "url": "data:image/jpeg;base64, "
                   + base64.b64encode(buf.getvalue()).decode()}})
    try:
        resps = get_judge()([
            {"role": "system", "content": [{"type": "text",
                                            "text": SYSTEM_PROMPT}]},
            {"role": "user", "content": parts}], max_tokens=1024)
    except Exception:
        resps = ""
    score, _ = get_score(resps)
    if score is None:
        score = resps
    raw, winner, judgement = classify_verdict(score)
    return {"question": doc["instruction"], "model_a": BASELINE_MODEL_NAME,
            "model_b": "evaluation_model", "winner": winner,
            "final_score": raw, "judgement": judgement,
            "model_resps": response}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"wildvision_raw_score": 0.0,
                "wildvision_elo_win_rate": 0.0,
                "wildvision_win_rate": 0.0}
    n = len(records)
    wins_b = sum(r["winner"] == "model_b" for r in records)
    ties = sum(r["winner"] == "tie" for r in records)
    out = {
        "wildvision_raw_score":
            sum(r["final_score"] for r in records) / n,
        # closed-form 2-model MLE elo win rate (see module docstring)
        "wildvision_elo_win_rate": round((wins_b + ties / 2) / n * 100, 2),
        "wildvision_win_rate": wins_b / n * 100,
    }
    for label in ("Better", "Better++", "Worse", "Worse++", "Tie",
                  "Unclear"):
        share = sum(r["judgement"] == label for r in records) / n * 100
        slug = label.lower().replace("++", "_plus")
        out[f"wildvision_judgement_{slug}"] = share
    return out


def _make_load(config: str):
    def load_docs(data_root: str, split: str = "test500") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("WildVision/wildvision-arena-data",
                                   data_root, split, subset=config)
    return load_docs


for _name, _config in (
        ("wildvision_0617", "release_bench_0617_with_modelresponse"),
        ("wildvision_0630", "release_bench_0630_with_modelresponse")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc.get(BASELINE_MODEL_NAME),
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="wildvision_elo_win_rate",
        load_docs=_make_load(_config),
        generation_kwargs={"max_new_tokens": 4096, "temperature": 0,
                           "do_sample": False},
    ))
