"""NExT-QA multiple-choice task (parity: lmms_eval/tasks/nextqa, _mc_test).

Docs: video (path or id) / question / a0..a4 option texts / answer (int).
Prompt = question + "A. text" lines + the letter instruction
(utils.py:59-71, nextqa_mc_test.yaml post_prompt); scoring uses the MMMU
multi-choice parser and exact letter match (utils.py:73-80). The
open-ended WUPS variant needs WordNet (unavailable offline) and is out of
scope.
"""

from __future__ import annotations

import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.extraction import parse_multi_choice_mmmu

_OPTIONS = ["A", "B", "C", "D", "E"]


def doc_to_visual(doc, data_root: str = ""):
    name = str(doc["video"])
    if not name.endswith(".mp4"):
        name += ".mp4"
    p = os.path.join(data_root, name) if data_root else name
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(
    doc, pre_prompt: str = "",
    post_prompt: str = "\nAnswer with the option's letter from the given choices directly.",
) -> str:
    lines = [doc["question"].strip()]
    for i in range(5):
        lines.append(f"{_OPTIONS[i]}. {doc[f'a{i}'].strip()}")
    question = "\n".join(lines)
    return f"{pre_prompt}{question}{post_prompt}"


def process_results(doc, response: str) -> dict:
    index2ans = {_OPTIONS[i]: doc[f"a{i}"].strip() for i in range(5)}
    parsed = parse_multi_choice_mmmu(response, _OPTIONS, index2ans,
                                     seed=doc.get("qid", doc.get("video")))
    return {
        "qid": doc.get("qid"),
        "pred": parsed,
        "answer": _OPTIONS[int(doc["answer"])],
        "exact_match": float(parsed == _OPTIONS[int(doc["answer"])]),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"nextqa_exact_match": 0.0}
    return {"nextqa_exact_match":
            100.0 * sum(r["exact_match"] for r in records) / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/NExTQA", data_root, split)


register_task(Task(
    name="nextqa_mc_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    # Gold letter; enables --num_fewshot labeled-example prefixes
    # (eval/fewshot.py) exactly as the reference's doc_to_target yaml key.
    doc_to_target=lambda doc: _OPTIONS[int(doc["answer"])],
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))


# ---- loglikelihood variant ------------------------------------------------
#
# MCQ scored by candidate loglikelihood instead of letter generation (the
# harness's loglikelihood output_type; reference api/model.py:29-60 +
# evaluator request-type dispatch). Each source doc expands into one request
# per option; the adapter scores the option text as the continuation and
# aggregation argmaxes per question — both raw (acc) and length-normalized
# (acc_norm, the lm-eval convention for unequal-length candidates).


from videoitg_tpu_torch.eval.mc_loglikelihood import make_mc_ll_suite

ll_expand_docs, ll_doc_to_target, ll_process_results, ll_aggregate = (
    make_mc_ll_suite(
        qid_of=lambda d: d.get("qid", d.get("video")),
        n_options_of=lambda d: 5,
        option_text_of=lambda d, i: d[f"a{i}"],
        answer_index_of=lambda d: d["answer"],
        metric_prefix="nextqa_ll",
    ))


def ll_doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "\nAnswer:"):
    return f"{pre_prompt}{doc['question'].strip()}{post_prompt}"


def ll_load_docs(data_root: str, split: str = "test") -> List[dict]:
    return ll_expand_docs(load_docs(data_root, split))


register_task(Task(
    name="nextqa_mc_ll",
    doc_to_visual=doc_to_visual,
    doc_to_text=ll_doc_to_text,
    doc_to_target=ll_doc_to_target,
    output_type="loglikelihood",
    process_results=ll_process_results,
    aggregate=ll_aggregate,
    load_docs=ll_load_docs,
    doc_id_key="_ll_id",
    primary_metric="nextqa_ll_acc",
))
