"""SynthDoG OCR (parity: lmms_eval/tasks/synthdog/utils.py +
donut_evaluator.py + synthdog_{en,zh}.yaml; group synthdog.yaml).

Full-page OCR over naver-clova-ix/synthdog-{en,zh} validation. Docs
carry image + ground_truth (a JSON string whose gt_parse is always
{"text_sequence": <page text>}).

Parity:
* doc_to_text: the fixed OCR instruction (synthdog_en.yaml doc_to_text).
* scoring: Donut's normalized tree-edit-distance accuracy
  (donut_evaluator.py:187-223 cal_acc) on pred {"output": response
  .lower().strip()} vs gt_parse. For this dataset's fixed shape both
  trees are root -> <field> -> <leaf>text, where the zss distance has
  the closed form 1 + edit_distance(pred_text, gt_text) (update the
  field node: non-leaf relabel cost 1 since "output" !=
  "text_sequence"; update the leaf: string edit distance) and the
  empty-vs-gt normalizer is 1 + len(gt_text) (insert field node cost
  1 + insert leaf cost len). So
      acc = max(0, 1 - (1 + ed(pred, gt)) / (1 + len(gt))),
  computed directly (no zss dependency). A remove+insert mapping
  costs (1+len(pred)) + (1+len(gt)) >= the update path, so the closed
  form is the zss optimum for this shape.
* aggregation: the reference's synthdog_aggregate_ted returns the raw
  SUM of per-sample scores (utils.py:41-45) — evidently unnormalized;
  reported here as synthdog_ted_sum (parity) alongside the mean
  (synthdog_ted, the headline).
"""

from __future__ import annotations

import json
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.metrics import levenshtein_distance

OCR_PROMPT = ("OCR this image section by section, from top to bottom, "
              "and left to right. Do not insert line breaks in the output "
              "text. If a word is split due to a line break in the image, "
              "use a space instead.")


def cal_acc_flat(pred_text: str, gt_text: str) -> float:
    """Closed-form nTED accuracy for the root->field-><leaf> shape
    (see module docstring for the derivation vs donut_evaluator.py)."""
    ed = levenshtein_distance(pred_text, gt_text)
    return max(0.0, 1 - (1 + ed) / (1 + len(gt_text)))


def doc_to_text(doc) -> str:
    return OCR_PROMPT


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_target(doc):
    gt = doc["ground_truth"]
    parse = (json.loads(gt) if isinstance(gt, str) else gt)["gt_parse"]
    return [parse["text_sequence"]]


def process_results(doc, response: str) -> dict:
    gt = doc["ground_truth"]
    parse = (json.loads(gt) if isinstance(gt, str) else gt)["gt_parse"]
    pred_text = response.lower().strip()
    return {"score": cal_acc_flat(pred_text,
                                  str(parse["text_sequence"])),
            "prediction": pred_text}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"synthdog_ted": 0.0}
    total = sum(r["score"] for r in records)
    return {"synthdog_ted": total / len(records),
            "synthdog_ted_sum": total}


def _make_load(hub: str):
    def load_docs(data_root: str, split: str = "validation") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(hub, data_root, split)
    return load_docs


for _name, _hub in (("synthdog_en", "naver-clova-ix/synthdog-en"),
                    ("synthdog_zh", "naver-clova-ix/synthdog-zh")):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=doc_to_target,
        process_results=process_results,
        aggregate=aggregate,
        primary_metric="synthdog_ted",
        load_docs=_make_load(_hub),
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))
