"""DetailCaps-4870 (parity: lmms_eval/tasks/detailcaps/utils.py +
detailcaps.yaml + _default_template_detailcaps_yaml).

Detailed image captioning (foundation-multimodal-models/DetailCaps-4870,
split test): the prompt is the fixed template default "Describe this
image in detail." (template yaml; overridable per model); references are
the THREE GT captions (GT_Caption_GPT4O / GT_Caption_GPT4V /
GT_Caption_Gemini15Pro, utils.py:31-37); the doc's image file name is
the coco image id (utils.py:50-51).

Scoring (utils.py:68-138): pycocoevalcap Bleu_1..4 / ROUGE_L / CIDEr
over the PTB-tokenized corpus — computed here with the in-tree
hand-port (eval/coco_caption.py, fuzz-cross-checked against
pycocoevalcap in tests/test_coco_oracle.py). Documented divergences,
both dependency-bound offline and both also gated/absent
upstream in comparable tasks: METEOR needs the Java meteor jar (omitted
exactly as in eval/coco_caption.py); CAPTURE (capture_metric package, a
T5-parser soft-match metric) has no offline counterpart — its column is
reported only when the package is importable, else omitted with this
note as the record.
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import compute_coco_metrics

PROMPT = "Describe this image in detail."


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:22-23 — the image ships as raw bytes in doc["binary"]
    (doc["image"] is the file NAME / coco id, not pixels)."""
    import io
    import os

    blob = doc.get("binary")
    if blob is not None:
        if hasattr(blob, "convert"):
            return blob
        from PIL import Image

        return Image.open(io.BytesIO(blob)).convert("RGB")
    p = (os.path.join(data_root, doc["image"]) if data_root
         else doc["image"])
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, prompt: str = PROMPT) -> str:
    """utils.py:26-28 — the prompt ignores the doc entirely."""
    return prompt


def doc_to_target(doc) -> List[str]:
    """utils.py:31-37."""
    return [doc["GT_Caption_GPT4O"], doc["GT_Caption_GPT4V"],
            doc["GT_Caption_Gemini15Pro"]]


def process_results(doc, response: str) -> dict:
    """utils.py:40-55 — one record feeds every metric."""
    return {"answer": doc_to_target(doc), "pred": response,
            "image_id": doc.get("image", "")}


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:68-138 via the in-tree coco scorers; CAPTURE only when
    the upstream package exists (it is not installed offline)."""
    recs = [{"video_id": r["image_id"], "pred": r["pred"],
             "answer": r["answer"]} for r in records]
    out = compute_coco_metrics(recs, prefix="detailcaps_")
    try:  # pragma: no cover - upstream-only dependency
        from capture_metric.capture import CAPTURE  # type: ignore

        gts = {r["image_id"]: list(r["answer"]) for r in records}
        res = {r["image_id"]: [r["pred"]] for r in records}
        score, _ = CAPTURE().compute_score(gts, res)
        out["detailcaps_CAPTURE"] = float(score)
    except ImportError:
        pass
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("foundation-multimodal-models/DetailCaps-4870",
                               data_root, split)


register_task(Task(
    name="detailcaps",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=doc_to_target,
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="detailcaps_CIDEr",
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 512, "temperature": 0,
                       "do_sample": False},
))
