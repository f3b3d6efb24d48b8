"""ScreenSpot (parity: lmms_eval/tasks/screenspot/utils.py +
utils_rec.py + the rec/reg yamls; group _screenspot.yaml).

GUI grounding over rootsautomation/ScreenSpot test. Docs carry
file_name / instruction / bbox (normalized xyxy) / data_type
(text|icon) / data_source (ios/android/macos/windows/web ids) / image.

* ``screenspot_rec_test`` — REC: the prompt asks for a two-decimal
  [0,1] xyxy box for the command (utils_rec.py:15-19); the first
  bracketed 4-float run is parsed ([0,0,0,0] fallback); metrics
  IoU / ACC@{.1,.3,.5,.7,.9} / Center_ACC (identical math to the
  refcoco REC suite — helpers reused from tasks/refcoco.py), each
  also rolled up per platform x type: mobile (ios|android), desktop
  (macos|windows), web (everything else) crossed with text|icon
  (utils_rec.py:128-180).
* ``screenspot_reg_test`` — REG (region captioning): the gold box is
  drawn as a width-3 red rectangle (bbox already xyxy,
  utils.py:8-15) and the model must produce the INSTRUCTION; scored
  with CIDEr against the single reference (utils.py:33-86) via
  eval/coco_caption.cider.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import cider, ptb_tokenize
from videoitg_tpu_torch.eval.tasks.refcoco import (
    compute_center_accuracy,
    compute_iou,
    parse_float_sequence_within,
)

REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are "
    "floating point numbers bounded between 0 and 1 with two decimal "
    "places of precision (e.g., 0.15). Please provide the bounding box "
    "coordinates of the region that corresponds to the command: ")

REC_METRICS = ("IoU", "ACC@0.1", "ACC@0.3", "ACC@0.5", "ACC@0.7",
               "ACC@0.9", "Center_ACC")


def _open_image(doc, data_root: str):
    import os

    from PIL import Image

    img = doc["image"]
    if hasattr(img, "convert"):
        return img.convert("RGB")
    p = os.path.join(data_root, img) if data_root else img
    with Image.open(p) as f:
        return f.convert("RGB")


def rec_doc_to_visual(doc, data_root: str = ""):
    return _open_image(doc, data_root)


def reg_doc_to_visual(doc, data_root: str = ""):
    """utils.py:8-15 — bbox is ALREADY xyxy here (unlike refcoco's
    xywh); width-3 red rectangle."""
    from PIL import ImageDraw

    image = _open_image(doc, data_root)
    b = doc["bbox"]
    ImageDraw.Draw(image).rectangle([b[0], b[1], b[2], b[3]],
                                    outline="red", width=3)
    return image


def rec_doc_to_text(doc) -> str:
    return REC_PROMPT + doc["instruction"]


def reg_doc_to_text(doc) -> str:
    b = doc["bbox"]
    return (f"Direct a user to interact with the highlighted region "
            f"[{b[0]:.2f}, {b[1]:.2f}, {b[2]:.2f}, {b[3]:.2f}].")


def _platform(source: str) -> str:
    if "ios" in source or "android" in source:
        return "mobile"
    if "macos" in source or "windows" in source:
        return "desktop"
    return "web"


def rec_process_results(doc, response: str) -> dict:
    return {"instruction": doc["instruction"],
            "pred": parse_float_sequence_within(response),
            "ann_id": doc["file_name"], "bbox": doc["bbox"],
            "data_type": doc["data_type"],
            "data_source": doc["data_source"]}


def rec_aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"screenspot_IoU": 0.0}
    out = {}
    for metric in REC_METRICS:
        if metric == "IoU":
            fn = compute_iou
        elif metric == "Center_ACC":
            fn = compute_center_accuracy
        else:
            th = float(metric.split("@")[1])
            fn = lambda g, p, th=th: compute_iou(g, p) >= th
        buckets: Dict[str, list] = {}
        scores = []
        for r in records:
            s = float(fn(r["bbox"], r["pred"]))
            scores.append(s)
            key = f"{_platform(r['data_source'])}_{r['data_type']}"
            buckets.setdefault(key, []).append(s)
        out[f"screenspot_{metric}"] = sum(scores) / len(scores)
        for k, v in sorted(buckets.items()):
            out[f"screenspot_{metric}-{k}"] = sum(v) / len(v)
    return out


def reg_process_results(doc, response: str) -> dict:
    return {"instruction": doc["instruction"], "pred": response,
            "ann_id": doc["file_name"]}


def reg_aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"screenspot_CIDEr": 0.0}
    gts, res = {}, {}
    for i, r in enumerate(records):
        gts[i] = [ptb_tokenize(r["instruction"])]
        res[i] = [ptb_tokenize(r["pred"])]
    return {"screenspot_CIDEr": cider(gts, res)}


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("rootsautomation/ScreenSpot", data_root,
                               split)


_GEN = {"until": ["ASSISTANT:"]}

register_task(Task(
    name="screenspot_rec_test",
    doc_to_visual=rec_doc_to_visual,
    doc_to_text=rec_doc_to_text,
    doc_to_target=lambda doc: doc.get("bbox"),
    process_results=rec_process_results,
    aggregate=rec_aggregate,
    primary_metric="screenspot_IoU",
    load_docs=_load,
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="screenspot_reg_test",
    doc_to_visual=reg_doc_to_visual,
    doc_to_text=reg_doc_to_text,
    doc_to_target=lambda doc: doc.get("instruction"),
    process_results=reg_process_results,
    aggregate=reg_aggregate,
    primary_metric="screenspot_CIDEr",
    load_docs=_load,
    generation_kwargs=dict(_GEN),
))
