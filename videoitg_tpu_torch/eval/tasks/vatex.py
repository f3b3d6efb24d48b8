"""VATEX English video-captioning task (vatex_test).

Parity: lmms_eval/tasks/vatex/ — docs carry videoID / enCap (a list of
~10 reference captions). The prompt is the yaml
lmms_eval_specific_kwargs prompt plus the fixed 4-example few-shot block
(utils.py:90-93). Scoring is corpus-level coco-caption
(utils.py:120-174): one BLEU/ROUGE_L/CIDEr computation over every doc,
Bleu_n picked from the bleu list; scores stay on the 0-1 scale (the
reference does NOT scale by 100 here). METEOR is omitted — the
reference's METEOR needs the Java meteor jar, unavailable offline; the
remaining metrics are exact reimplementations (eval/coco_caption.py).
The Chinese variant (vatex_val_zh) is not ported: the PTB jar the
reference tokenizes with does not segment Chinese either, so its scores
are not meaningful to reproduce.
"""

from __future__ import annotations

import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import compute_coco_metrics

PROMPT = ("Provide a brief single-sentence caption for the last video "
          "below. Do not give any reasoning, just the caption. You must "
          "follow the captioning style of the preceding videos. Do not "
          'start your response with "Output:", just provide the caption.')

# reference utils.py:92 vatex_test_doc_to_text few-shot block, verbatim
FEW_SHOT = (
    "[video1] output: A man picks up a can of shoe paste, a towel, and "
    "brush from a table.\n"
    "[video2] output: A person places the frying pan on the stove and "
    "then another person flips over the food that is in it.\n"
    "[video3] output: A woman describes and demonstrates how to create a "
    "colorful cross stitch design.\n"
    "[video4] output: A little girl uses the grass in her yard as well "
    "as a blue mat to do flips.\n"
)


def doc_to_visual(doc, data_root: str = ""):
    base = doc["videoID"]
    for ext in (".mp4", ".MP4", ".mkv"):
        path = os.path.join(data_root, base + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(data_root, base + ".mp4"))


def doc_to_text(doc, prompt: str = PROMPT):
    return f"{prompt}\n{FEW_SHOT}"


def process_results(doc, response: str) -> dict:
    return {"answer": list(doc["enCap"]),
            "pred": response if isinstance(response, str) else "",
            "video_id": doc["videoID"]}


def aggregate(records: List[dict]) -> Dict[str, float]:
    return compute_coco_metrics(records, prefix="vatex_")


register_task(Task(
    name="vatex_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=lambda data_root, split="test": __import__(
        "videoitg_tpu_torch.eval.loaders", fromlist=["load_benchmark_docs"]
    ).load_benchmark_docs("lmms-lab/VATEX", data_root, split,
                          subset="vatex_test"),
    doc_id_key=None,
    primary_metric="vatex_CIDEr",
    generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                       "do_sample": False},
))
