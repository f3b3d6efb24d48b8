"""Image-captioning benchmark family: COCO-Caption 2014/2017, NoCaps,
TextCaps, Flickr30k (parity: lmms_eval/tasks/coco_cap/utils.py +
coco201{4,7}_cap_{val,test}.yaml, tasks/nocaps/utils.py +
_default_template_nocaps_yaml, tasks/textcaps/utils.py +
_default_template_textcaps_yaml, tasks/flickr30k/utils.py +
flickr30k_test.yaml).

All five share one shape — fixed prompt "Provide a one-sentence caption
for the provided image." (each task's yaml/template carries the same
string), multi-reference gold captions, pycocoevalcap scoring over
Bleu_1..4 / ROUGE_L / CIDEr (eval/coco_caption.py, verified against an
independently hand-ported pycocoevalcap oracle; METEOR omitted — the
reference needs the Java meteor jar) — so one factory registers them
all. Per-family differences are just the gold field and the image id:

- coco2014/2017_cap_val|test: answers in doc["answer"]; image_id parsed
  from the filename-style question_id (coco_cap/utils.py:33-35); test is
  submission-only (coco_test_process_result passthrough).
- nocaps_val|test: answers in doc["annotations_captions"], image_id
  field; test submission-only.
- textcaps_val|test: answers in doc["caption_str"], image_id field
  (kept as-is, textcaps/utils.py:52 does not int-cast); test
  submission-only.
- flickr30k_test: answers in doc["caption"], int(doc["img_id"]) —
  scored (flickr30k has no withheld split).

Scored-split records double as submission rows ({image_id, caption} =
the stored_results JSON the reference writes, coco_cap/utils.py:55).
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.coco_caption import compute_coco_metrics

CAPTION_PROMPT = "Provide a one-sentence caption for the provided image."


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, prompt: str = CAPTION_PROMPT) -> str:
    return prompt


def _coco_image_id(doc):
    # "COCO_val2014_000000391895.jpg" -> 391895 (coco_cap/utils.py:33-35)
    return int(str(doc["question_id"]).split("_")[-1].split(".")[0])


_FAMILIES = {
    # name -> (hub dataset, answer field, image_id fn, (scored, submission) splits)
    "coco2014_cap": ("lmms-lab/COCO-Caption", "answer", _coco_image_id,
                     ("val", "test")),
    "coco2017_cap": ("lmms-lab/COCO-Caption2017", "answer", _coco_image_id,
                     ("val", "test")),
    "nocaps": ("lmms-lab/NoCaps", "annotations_captions",
               lambda d: d["image_id"], ("validation", "test")),
    "textcaps": ("lmms-lab/TextCaps", "caption_str",
                 lambda d: d["image_id"], ("val", "test")),
    "flickr30k": ("lmms-lab/flickr30k", "caption",
                  lambda d: int(d["img_id"]), ("test", None)),
}


def _make_process_results(answer_field: str, image_id_fn, scored: bool):
    def process_results(doc, response: str) -> dict:
        rec = {"image_id": image_id_fn(doc), "pred": response}
        if scored:
            answers = doc[answer_field]
            rec["answer"] = (list(answers) if isinstance(answers,
                                                         (list, tuple))
                             else [answers])
        return rec
    return process_results


def _make_aggregate(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        return compute_coco_metrics(records, prefix=f"{prefix}_")
    return aggregate


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    # test splits are submission-only upstream (the *_test_process_result
    # passthroughs just dump {image_id, caption} rows); samples.jsonl
    # carries them per sample here.
    return {"submission_rows": float(len(records))}


def _make_load_docs(repo: str, default_split: str):
    def load_docs(data_root: str, split: str = default_split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(repo, data_root, split)
    return load_docs


for _name, (_repo, _field, _idfn, (_val_split, _test_split)) \
        in _FAMILIES.items():
    # flickr30k's single registered task keeps the bare family name
    # (reference task name "flickr30k_test" — kept).
    _valname = ("flickr30k_test" if _name == "flickr30k"
                else f"{_name}_val")
    # metric prefix: coco_Bleu_4 etc. share "coco" across 2014/2017
    # upstream; keeping them distinct here so a joint run is unambiguous.
    _prefix = "flickr" if _name == "flickr30k" else _name
    register_task(Task(
        name=_valname,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc, _f=_field: doc.get(_f),
        process_results=_make_process_results(_field, _idfn, scored=True),
        aggregate=_make_aggregate(_prefix),
        primary_metric=f"{_prefix}_CIDEr",
        load_docs=_make_load_docs(_repo, _val_split),
        generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                           "do_sample": False},
    ))
    if _test_split:
        register_task(Task(
            name=f"{_name}_test",
            doc_to_visual=doc_to_visual,
            doc_to_text=doc_to_text,
            process_results=_make_process_results(_field, _idfn,
                                                  scored=False),
            aggregate=_aggregate_submission,
            load_docs=_make_load_docs(_repo, _test_split),
            generation_kwargs={"max_new_tokens": 128, "temperature": 0,
                               "do_sample": False},
        ))
