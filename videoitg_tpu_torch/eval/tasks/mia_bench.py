"""MIA-Bench (parity: lmms_eval/tasks/mia_bench/utils.py +
mia_bench.yaml).

Instruction-adherence benchmark (lmms-lab/MIA-Bench, split test): each
doc carries an instruction, a components list (the instruction's
sub-requirements), and component_weight (per-component point values
summing to 10). The model's response is scored by a judge prompted to
grade each component and emit "score of component 1: x/2, ..., total
score: z/10" as the FIRST sentence (generate_prompt, utils.py:97-150);
process_rawscore (utils.py:153-169) splits that first sentence on
commas and each "label: x/y" on ":" and "/" — unparseable reviews
yield total_score 0. Aggregation is the mean total_score
(utils.py:186-191).

The judge prompt text is a verbatim behavioral constant (a changed word
changes the metric). The reference hardcodes the 1..5-component prompt
expansions as an if/elif chain (utils.py:103-139); the loop below
produces byte-identical strings for those counts (fuzz-checked in
tests/test_judge_tasks.py against the chain's wording).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.llava_bench import doc_to_visual


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    """utils.py:20-28."""
    return f"{pre_prompt}{doc['instruction']}{post_prompt}"


# utils.py:103-139 — the reference's if/elif chain hardcodes these
# prefixes with IRREGULAR commas ("The first second, and third ..."; no
# comma before "and fifth"); preserved verbatim per component count.
_SCORE_PREFIX = {
    1: "The first component is worth ",
    2: "The first and second component is each worth ",
    3: "The first second, and third component is each worth ",
    4: "The first second, third, and fourth component is each worth ",
    5: "The first second, third, fourth and fifth component is each worth ",
}


def generate_prompt(doc: dict, response: str) -> str:
    """utils.py:97-150 — byte-exact for 1..5 components."""
    instruction = doc["instruction"]
    weight = [str(w) for w in doc["component_weight"]]
    comps = doc["components"]
    n = len(comps)
    ordinals = ["first", "second", "third", "fourth", "fifth"]
    components = "The first component is:' " + comps[0] + "'"
    for i in range(1, n):
        components += (", and the " + ordinals[i] + " component is:' "
                       + comps[i] + "'")
    if n == 1:
        joined = weight[0]
    elif n == 2:
        joined = weight[0] + " and " + weight[1]
    else:
        joined = ", ".join(weight[:-1]) + " and " + weight[-1]
    score = _SCORE_PREFIX[n] + joined + " scores."
    return (
        "Here is an instruction for a multimodal LLM: ' "
        + instruction
        + " You need to grade if the response from the model follows each "
          "component of the instruction. "
        + components
        + " The response is:' "
        + response
        + "' You need to score the response and be strict. The total score "
          "ranges from 0 to 10, depending on if the response follows the "
          "instruction. "
        + score
        + " List scores of each component, and the total score in one "
          "sentence in this format: score of component 1: x/2, score of "
          "component 2: y/8, total score: z/10. Then explain your reasons."
    )


def process_rawscore(component_type: List[str], raw_score: str) -> dict:
    """utils.py:153-169 — first-sentence "label: x/y" parser; the
    reference raises on malformed fragments inside its own try-free
    loop, so callers guard (process_results wraps in try/except -> 0)."""
    first_sentence = raw_score.split(".")[0].split(",")
    score_dict = {}
    for i in range(len(first_sentence) - 1):
        score_ = first_sentence[i].split(":")[1][1:].split("/")
        score = int(score_[0]) / int(score_[1])
        score_dict[component_type[i]] = score
    if len(first_sentence) > 1:
        total_score_ = first_sentence[-1].split(":")[1][1:].split("/")
        score_dict["total_score"] = int(total_score_[0]) / int(total_score_[1])
    else:
        score_dict["total_score"] = 0
    return score_dict


def process_results(doc, response: str) -> dict:
    """utils.py:172-178 (+ the get_eval empty-on-failure contract,
    utils.py:62-94: judge failures score 0)."""
    response = response.strip()
    eval_prompt = generate_prompt(doc, response)
    judge = get_judge()
    try:
        eval_score = judge([{"role": "user", "content": eval_prompt}],
                           max_tokens=1024)
        score_dict = process_rawscore(doc["components"], eval_score)
    except Exception:
        score_dict = {"total_score": 0}
    return {"total_score": score_dict.get("total_score", 0),
            "components": score_dict}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:186-191."""
    if not records:
        return {"gpt_eval_score": 0.0}
    total = sum(r["total_score"] for r in records)
    return {"gpt_eval_score": total / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/MIA-Bench", data_root, split)


register_task(Task(
    name="mia_bench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("instruction", ""),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="gpt_eval_score",
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 512},
))
