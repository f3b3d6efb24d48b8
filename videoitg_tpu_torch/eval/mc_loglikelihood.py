"""Shared MCQ-by-loglikelihood machinery.

MCQ tasks scored by candidate likelihood (the reference's *_mcppl yamls,
e.g. perceptiontest_mcppl.yaml; lm-eval's multiple_choice output type):
each source doc expands into one loglikelihood request per option, the
option text is the continuation, and aggregation argmaxes per question —
both raw (acc) and length-normalized (acc_norm, the lm-eval convention
for unequal-length candidates). nextqa_mc_ll and perceptiontest_val_mcppl
both build from this factory.
"""

from __future__ import annotations

from typing import Callable, Dict, List


def make_mc_ll_suite(
    *,
    qid_of: Callable[[dict], object],
    n_options_of: Callable[[dict], int],
    option_text_of: Callable[[dict, int], str],
    answer_index_of: Callable[[dict], int],
    metric_prefix: str,
):
    """Returns (expand_docs, doc_to_target, process_results, aggregate).

    expand_docs adds `_choice` (the option index) and `_ll_id`
    ("{qid}::{choice}", the request doc_id) per option.
    """

    def expand_docs(docs: List[dict]) -> List[dict]:
        out = []
        for doc in docs:
            qid = qid_of(doc)
            for i in range(n_options_of(doc)):
                out.append({**doc, "_choice": i, "_ll_id": f"{qid}::{i}"})
        return out

    def doc_to_target(doc) -> str:
        return " " + option_text_of(doc, doc["_choice"]).strip()

    def process_results(doc, resp) -> dict:
        ll, greedy = float(resp[0]), bool(resp[1])
        target = doc_to_target(doc)
        return {
            "qid": str(qid_of(doc)),
            "choice": doc["_choice"],
            "is_answer": int(doc["_choice"]) == int(answer_index_of(doc)),
            "ll": ll,
            "ll_norm": ll / max(1, len(target)),
            "greedy": greedy,
        }

    def aggregate(records: List[dict]) -> Dict[str, float]:
        by_q: Dict[str, List[dict]] = {}
        for r in records:
            by_q.setdefault(r["qid"], []).append(r)
        acc = acc_norm = 0.0
        complete = 0
        for _qid, cands in by_q.items():
            if len(cands) < 2:
                continue  # partial question (e.g. --limit cut mid-expansion)
            complete += 1
            acc += float(max(cands, key=lambda r: r["ll"])["is_answer"])
            acc_norm += float(max(cands, key=lambda r: r["ll_norm"])["is_answer"])
        n = max(1, complete)
        return {f"{metric_prefix}_acc": 100.0 * acc / n,
                f"{metric_prefix}_acc_norm": 100.0 * acc_norm / n}

    return expand_docs, doc_to_target, process_results, aggregate
