"""IFEval task (parity: lmms_eval/tasks/ifeval/ifeval.yaml + utils.py;
the checker suite lives in videoitg_tpu/eval/ifeval.py).

Instruction-following (wis-k/instruction-following-eval, split train —
it IS the eval set upstream). The prompt is doc["prompt"] verbatim;
each doc lists instruction ids + kwargs. Scoring (utils.py:112-139):
strict (raw response) and loose (8 relaxed variants) instruction
checks, reported at the prompt level (all instructions followed) and
the instruction level (per-instruction mean over the flattened list,
agg_inst_level_acc utils.py:135-139).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.ifeval import (
    InputExample,
    test_instruction_following_loose,
    test_instruction_following_strict,
)
from videoitg_tpu_torch.eval.tasks.text_mc import no_visual


def doc_to_text(doc) -> str:
    return doc["prompt"]


def process_results(doc, response: str) -> dict:
    inp = InputExample(
        key=doc.get("key", 0),
        instruction_id_list=doc["instruction_id_list"],
        prompt=doc["prompt"],
        kwargs=doc["kwargs"],
    )
    strict = test_instruction_following_strict(inp, response)
    loose = test_instruction_following_loose(inp, response)
    return {
        "key": doc.get("key", 0),
        "strict_list": strict,
        "loose_list": loose,
        "prompt_strict": all(strict),
        "prompt_loose": all(loose),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"prompt_level_strict_acc": 0.0,
                "inst_level_strict_acc": 0.0,
                "prompt_level_loose_acc": 0.0,
                "inst_level_loose_acc": 0.0}
    flat_strict = [b for r in records for b in r["strict_list"]]
    flat_loose = [b for r in records for b in r["loose_list"]]
    n = len(records)
    return {
        "prompt_level_strict_acc":
            sum(r["prompt_strict"] for r in records) / n,
        "inst_level_strict_acc":
            sum(flat_strict) / max(1, len(flat_strict)),
        "prompt_level_loose_acc":
            sum(r["prompt_loose"] for r in records) / n,
        "inst_level_loose_acc":
            sum(flat_loose) / max(1, len(flat_loose)),
    }


def load_docs(data_root: str, split: str = "train") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("wis-k/instruction-following-eval",
                               data_root, split)


register_task(Task(
    name="ifeval",
    doc_to_visual=no_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: "0",
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="prompt_level_strict_acc",
    load_docs=load_docs,
    doc_id_key="key",
    generation_kwargs={"until": [], "do_sample": False,
                       "temperature": 0.0, "max_new_tokens": 1280},
))
