"""NaturalBench (parity: lmms_eval/tasks/naturalbench/utils.py +
naturalbench.yaml).

Adversarial natural-image VQA over BaiqiL/NaturalBench-lmms-eval test.
Samples come in GROUPS OF FOUR consecutive rows — (question_0,
image_0), (q0, i1), (q1, i0), (q1, i1) — where by construction the
gold pattern is yes/A, no/B, no/B, yes/A (extract_answer encodes the
gold directly: 1 = yes/A, 0 = no/B).

Parity:
* doc_to_text (utils.py:158-165): question + the per-type suffix
  ("Please answer Yes or No." / "Please output the letter
  corresponding to the correct option.").
* extract_answer (utils.py:113-152): first word-boundary occurrence
  of yes vs no (or A vs B, case-INSENSITIVE — so a lowercase "a"
  matches option A; preserved), earlier position wins; -1 when
  neither appears.
* scoring (utils.py:16-110 get_scores): groups keyed by Index//4 with
  the in-group slot asserted from Index (utils.py:190-196);
  Acc = mean over all 4 slots of (slot matches its gold pattern);
  Q_Acc / I_Acc require both slots of a question/image pair correct;
  G_Acc requires the whole group. The reference hard-asserts
  len == 1900*4 (the full split); this port asserts divisibility by 4
  so fixtures run — the math is identical.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

SUFFIX_FOR_VQA = {
    "yes_no": "Please answer Yes or No.",
    "multiple_choice": ("Please output the letter corresponding to the "
                        "correct option."),
}


def extract_answer(output_string: str, task_type: str = "yes_no") -> int:
    """utils.py:113-152."""
    if task_type not in ("yes_no", "multiple_choice"):
        raise ValueError("Task type not supported. Must be 'yes_no' or "
                         "'multiple_choice'.")

    def pos(word: str) -> int:
        m = re.search(r"\b" + re.escape(word) + r"\b", output_string,
                      re.IGNORECASE)
        return m.start() if m else -1

    if task_type == "yes_no":
        p1, p0 = pos("yes"), pos("no")
    else:
        p1, p0 = pos("A"), pos("B")
    if p1 == -1 and p0 == -1:
        return -1
    if p1 != -1 and p0 != -1:
        return 1 if p1 < p0 else 0
    return 0 if p1 == -1 else 1


def doc_to_text(doc) -> str:
    q = doc["Question"]
    suffix = SUFFIX_FOR_VQA.get(doc["Question_Type"])
    return f"{q} {suffix}" if suffix else q


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["Image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    return {"id": int(doc["Index"]),
            "score": extract_answer(response,
                                    task_type=doc["Question_Type"])}


def get_scores(groups: List[List[float]]) -> Dict[str, float]:
    """utils.py:16-110 — [q0_i0, q0_i1, q1_i0, q1_i1] per group."""
    n = len(groups)
    q_acc = i_acc = acc = g_acc = 0.0
    for g in groups:
        q = int(g[0] == 1.0 and g[1] == 0.0) + int(g[3] == 1.0
                                                   and g[2] == 0.0)
        i = int(g[0] == 1.0 and g[2] == 0.0) + int(g[3] == 1.0
                                                   and g[1] == 0.0)
        b = (int(g[0] == 1.0) + int(g[1] == 0.0) + int(g[2] == 0.0)
             + int(g[3] == 1.0))
        q_acc += q
        i_acc += i
        acc += b
        g_acc += int(q == 2 and i == 2)
    return {"Q_Acc": q_acc / (n * 2), "I_Acc": i_acc / (n * 2),
            "Acc": acc / (n * 4), "G_Acc": g_acc / n}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"naturalbench_G_Acc": 0.0}
    assert len(records) % 4 == 0, "naturalbench rows come in groups of 4"
    by_id = sorted(records, key=lambda r: r["id"])
    groups = []
    for i in range(len(by_id) // 4):
        quad = by_id[i * 4:(i + 1) * 4]
        base = quad[0]["id"]
        assert [r["id"] for r in quad] == [base, base + 1, base + 2,
                                           base + 3], "broken group"
        groups.append([r["score"] for r in quad])
    scores = get_scores(groups)
    return {f"naturalbench_{k}": v for k, v in scores.items()}


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("BaiqiL/NaturalBench-lmms-eval", data_root,
                               split)


register_task(Task(
    name="naturalbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("Answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="naturalbench_G_Acc",
    load_docs=_load,
    doc_id_key="Index",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
