"""RefCOCO / RefCOCO+ / RefCOCOg (parity: lmms_eval/tasks/refcoco{,+,g}/
utils.py + utils_rec.py + the per-split yamls; the three dirs are
_generate_config.py clones differing only in dataset id and splits).

Region-level grounding over lmms-lab/RefCOCO{,plus,g}. Three task types
per dataset:

* ``*_bbox_*`` — region CAPTIONING: the gold box is drawn on the image
  as a red (width-1, default) rectangle after (x,y,w,h) -> xyxy
  conversion (utils.py:12-19); prompt "Provide a short description for
  this region."; coco captioning metrics over the multi-reference
  answers (Bleu_1-4/ROUGE_L/CIDEr via eval/coco_caption.py — METEOR is
  omitted there, needs the reference's java jar).
* ``*_seg_*`` — same captioning task with the gold segmentation
  polygon outlined instead (utils.py:22-27).
* ``*_bbox_rec_*`` — referring-expression COMPREHENSION: docs are
  EXPLODED one row per referring expression and the gold box is
  normalized to [0,1] xyxy (utils_rec.py:11-38, done here inside
  load_docs); the prompt asks for "(top-left x, top-left y,
  bottom-right x, bottom-right y)" floats; the FIRST bracketed
  4-float sequence is parsed ([0,0,0,0] when absent,
  utils_rec.py:56-77); metrics are mean IoU, ACC@{.1,.3,.5,.7,.9} and
  Center_ACC (gold-box containment of the predicted center),
  utils_rec.py:95-190.

Metric keys keep the reference's shared ``refcoco_`` prefix across all
three datasets (refcoco+/utils_rec.py:92 uses the same literal).

Splits: refcoco val/testA/testB/test (rec+bbox+seg), refcoco+
val/testA/testB, refcocog val/test — 27 tasks; groups
``{ds}_bbox_rec`` / ``{ds}_bbox`` / ``{ds}_seg`` per dataset mirror
the per-yaml group fields.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import compute_coco_metrics

REC_METRICS = ("IoU", "ACC@0.1", "ACC@0.3", "ACC@0.5", "ACC@0.7",
               "ACC@0.9", "Center_ACC")

REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are "
    "floating point numbers bounded between 0 and 1. Please provide the "
    "bounding box coordinate of the region this sentence describes: ")

_BBOX_RE = re.compile(
    r"\[\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?),"
    r"\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?)\s*\]")


def parse_float_sequence_within(s: str) -> List[float]:
    """utils_rec.py:56-77 — first bracketed 4-float run, else zeros."""
    m = _BBOX_RE.search(s)
    return [float(m.group(i)) for i in range(1, 5)] if m else [0, 0, 0, 0]


def compute_iou(b1, b2) -> float:
    """utils_rec.py:95-125 (no clamping of degenerate boxes upstream)."""
    xl, yt = max(b1[0], b2[0]), max(b1[1], b2[1])
    xr, yb = min(b1[2], b2[2]), min(b1[3], b2[3])
    inter = max(0, xr - xl) * max(0, yb - yt)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    return inter / (a1 + a2 - inter)


def compute_center_accuracy(b1, b2) -> bool:
    """utils_rec.py:147-163 — center of the PREDICTION inside the gold."""
    cx, cy = (b2[0] + b2[2]) / 2, (b2[1] + b2[3]) / 2
    return b1[0] <= cx <= b1[2] and b1[1] <= cy <= b1[3]


def _open_image(doc, data_root: str):
    import os

    from PIL import Image

    img = doc["image"]
    if hasattr(img, "convert"):
        return img.convert("RGB")
    p = os.path.join(data_root, img) if data_root else img
    with Image.open(p) as f:
        return f.convert("RGB")


def bbox_doc_to_visual(doc, data_root: str = ""):
    """utils.py:12-19 — red xyxy rectangle over the gold region."""
    from PIL import ImageDraw

    image = _open_image(doc, data_root)
    b = doc["bbox"]  # dataset-native (x, y, w, h)
    ImageDraw.Draw(image).rectangle(
        [b[0], b[1], b[0] + b[2], b[1] + b[3]], outline="red")
    return image


def seg_doc_to_visual(doc, data_root: str = ""):
    """utils.py:22-27 — gold polygon outline (default 1px black)."""
    from PIL import ImageDraw

    image = _open_image(doc, data_root)
    ImageDraw.Draw(image).polygon([float(v) for v in doc["segmentation"]])
    return image


def rec_doc_to_visual(doc, data_root: str = ""):
    return _open_image(doc, data_root)


def caption_doc_to_text(doc) -> str:
    return "Provide a short description for this region."


def rec_doc_to_text(doc) -> str:
    assert isinstance(doc["answer"], str), "Answer must be a string"
    return REC_PROMPT + doc["answer"]


def caption_process_results(doc, response: str) -> dict:
    answers = doc["answer"]
    return {"ann_id": doc["question_id"], "pred": response,
            "answer": (list(answers) if isinstance(answers, (list, tuple))
                       else [answers])}


def caption_aggregate(records: List[dict]) -> Dict[str, float]:
    return compute_coco_metrics(records, prefix="refcoco_")


def rec_process_results(doc, response: str) -> dict:
    return {"ann_id": doc["question_id"],
            "pred": parse_float_sequence_within(response),
            "answer": doc["answer"], "bbox": doc["bbox"]}


def rec_aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"refcoco_IoU": 0.0}
    out = {}
    for metric in REC_METRICS:
        if metric == "IoU":
            fn = compute_iou
        elif metric == "Center_ACC":
            fn = compute_center_accuracy
        else:
            th = float(metric.split("@")[1])
            fn = lambda g, p, th=th: compute_iou(g, p) >= th
        out[f"refcoco_{metric}"] = (
            sum(float(fn(r["bbox"], r["pred"])) for r in records)
            / len(records))
    return out


def rec_explode_docs(docs: List[dict], data_root: str = "") -> List[dict]:
    """utils_rec.py:11-38: normalize the gold box to [0,1] xyxy using
    the image dims, then one row per referring expression. Local
    fixture docs may carry image_width/image_height directly; otherwise
    the dims are read from the image file."""
    out = []
    for doc in docs:
        w, h = doc.get("image_width"), doc.get("image_height")
        if not (w and h):
            img = _open_image(doc, data_root)
            w, h = img.size
        b = doc["bbox"]
        norm = [b[0] / w, b[1] / h, (b[0] + b[2]) / w, (b[1] + b[3]) / h]
        answers = doc["answer"]
        if isinstance(answers, str):
            answers = [answers]
        for a in answers:
            out.append({**doc, "bbox": norm, "answer": a,
                        "image_width": w, "image_height": h})
    return out


_DATASETS = (
    # (task prefix, hub dataset, splits)
    ("refcoco", "lmms-lab/RefCOCO", ("val", "testA", "testB", "test")),
    ("refcoco+", "lmms-lab/RefCOCOplus", ("val", "testA", "testB")),
    ("refcocog", "lmms-lab/RefCOCOg", ("val", "test")),
)


def _make_load(hub: str, split: str, explode: bool):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        docs = load_benchmark_docs(hub, data_root, split_)
        return rec_explode_docs(docs, data_root) if explode else docs
    return load_docs


_GEN = {"until": ["ASSISTANT:"]}

for _ds, _hub, _splits in _DATASETS:
    for _split in _splits:
        register_task(Task(
            name=f"{_ds}_bbox_rec_{_split}",
            doc_to_visual=rec_doc_to_visual,
            doc_to_text=rec_doc_to_text,
            doc_to_target=lambda doc: doc.get("bbox"),
            process_results=rec_process_results,
            aggregate=rec_aggregate,
            primary_metric="refcoco_IoU",
            load_docs=_make_load(_hub, _split, explode=True),
            generation_kwargs=dict(_GEN),
        ))
        for _kind, _visual in (("bbox", bbox_doc_to_visual),
                               ("seg", seg_doc_to_visual)):
            register_task(Task(
                name=f"{_ds}_{_kind}_{_split}",
                doc_to_visual=_visual,
                doc_to_text=caption_doc_to_text,
                doc_to_target=lambda doc: doc.get("answer"),
                process_results=caption_process_results,
                aggregate=caption_aggregate,
                primary_metric="refcoco_CIDEr",
                load_docs=_make_load(_hub, _split, explode=False),
                doc_id_key="question_id",
                generation_kwargs=dict(_GEN),
            ))
