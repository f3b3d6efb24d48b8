"""MM-Vet v1 + v2 (parity: lmms_eval/tasks/mmvet/utils.py + mmvet.yaml;
lmms_eval/tasks/mmvetv2/utils.py + mmvetv2.yaml + mmvetv2_group_img.yaml).

Open-ended integrated-capability QA scored by a 0.0–1.0 GPT judge.

* ``mmvet`` (lmms-lab/MMVet test): docs {question_id, question, answer
  (with <AND>/<OR> markers), capability — comma-joined string, image}.
* ``mmvetv2`` (whyu/mm-vet-v2 test): docs {id, question with inline
  <image_N> tokens and <IMG> separators, answer, capability — a LIST,
  image_0..image_17 fields}. doc_to_visual resolves the <image_N>
  tokens in question order (mmvetv2/utils.py:149-153); doc_to_text
  strips the <IMG> separators and, because the vendored config sets
  interleaved_format: false, leaves the <image_N> tokens in the prompt
  verbatim (utils.py:156-164).
* ``mmvetv2_group_img``: same docs, but the images are composited into
  ONE labeled image for single-image models (mmvetv2_group_img.yaml):
  each image is resized to a 1008px edge, stamped with an "[N]" order
  label, and the concatenation (horizontal vs vertical) whose aspect
  ratio is least extreme wins (utils.py:14-147). DIVERGENCE: the
  reference stamps labels with a vendored arial.ttf; this port uses
  PIL's bundled default font at the same 40px size — label pixels
  differ, the [N]-ordering semantics the judge relies on do not.

Scoring parity (identical in v1/v2, mmvet/utils.py:104-151): one judge
call per sample with MM_VET_PROMPT + "question | gt | pred |"; the
reply's first whitespace token must parse as a float in [0,1]. The
reference retries at increasing temperature until it gets one and
falls back to 0.0; offline judges are deterministic, so this port
parses once and scores 0.0 on failure (same terminal fallback).

Aggregation (mmvet/utils.py:154-230): overall = mean(score)*100 (the
headline metric), per-capability means over {rec,ocr,know,gen,spat,
math} (+seq for v2; membership is substring-on-comma-string in v1,
list membership in v2 — preserved), and per capability-combination
means (exact set match) for the combinations present.
"""

from __future__ import annotations

import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

# mmvet/utils.py:38-47 == mmvetv2/utils.py:314-323 — verbatim parity
# contract (the judge rubric; a changed word changes the metric).
MM_VET_PROMPT = """Compare the ground truth and prediction from AI models, to give a correctness score for the prediction. <AND> in the ground truth means it is totally right only when all elements in the ground truth are present in the prediction, and <OR> means it is totally right when any one element in the ground truth is present in the prediction. The correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last space of the correctness score.
gpt_query_prompt | Ground truth | Prediction | Correctness
--- | --- | --- | ---
What is x in the equation? | -1 <AND> -5 | x = 3 | 0.0
What is x in the equation? | -1 <AND> -5 | x = -1 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 or 5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -1 or x = -5 | 1.0
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme talks about Iceland and Greenland. It's pointing out that despite their names, Iceland is not very icy and Greenland isn't very green. | 0.4
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme is using humor to point out the misleading nature of Iceland's and Greenland's names. Iceland, despite its name, has lush green landscapes while Greenland is mostly covered in ice and snow. The text 'This is why I have trust issues' is a playful way to suggest that these contradictions can lead to distrust or confusion. The humor in this meme is derived from the unexpected contrast between the names of the countries and their actual physical characteristics. | 1.0
"""

CAPS_V1 = ("rec", "ocr", "know", "gen", "spat", "math")
CAPS_V2 = CAPS_V1 + ("seq",)

# mmvet.yaml lmms_eval_specific_kwargs (same text in mmvetv2.yaml)
PRE_PROMPT = ("First please perform reasoning, and think step by step to "
              "provide best answer to the following question: \n\n")

_IMAGE_TOKEN_RE = re.compile(r"<image_\d+>")


def judge_score(question: str, answer: str, pred: str, judge=None) -> float:
    """One rubric call; first token parsed as a float in [0,1]
    (mmvet/utils.py:110-136)."""
    judge = judge or get_judge()
    prompt = (f"{MM_VET_PROMPT}\n{question} | "
              f"{answer.replace('<AND>', ' <AND> ').replace('<OR>', ' <OR> ')}"
              f" | {pred} |")
    try:
        content = judge([{"role": "user", "content": prompt}],
                        max_tokens=128)
        score = float(content.split(" ")[0].strip())
        return score if 0.0 <= score <= 1.0 else 0.0
    except Exception:
        return 0.0


def _aggregate(records: List[dict], caps: tuple,
               prefix: str) -> Dict[str, float]:
    if not records:
        return {f"{prefix}_overall": 0.0}
    out = {f"{prefix}_overall":
           100.0 * sum(r["score"] for r in records) / len(records)}
    for cap in caps:
        # v1: substring on the comma-joined string; v2: list membership
        # (mmvet/utils.py:176-180 vs mmvetv2/utils.py:374-378)
        sub = [r for r in records if cap in r["capabilities"]]
        if sub:
            out[f"{prefix}_{cap}"] = (100.0 * sum(r["score"] for r in sub)
                                      / len(sub))
    combos = {}
    for r in records:
        c = r["capabilities"]
        key = frozenset(c.split(",") if isinstance(c, str) else c)
        combos.setdefault(key, []).append(r["score"])
    for key, scores in sorted(combos.items(),
                              key=lambda kv: sorted(kv[0])):
        slug = "_".join(sorted(key))
        out[f"{prefix}_detail_{slug}"] = 100.0 * sum(scores) / len(scores)
    return out


# ---------------------------------------------------------------------------
# v1
# ---------------------------------------------------------------------------

def doc_to_text(doc, pre_prompt: str = PRE_PROMPT,
                post_prompt: str = "") -> str:
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def doc_to_visual_v1(doc, data_root: str = ""):
    import os

    if doc.get("image") is None:
        return None  # mmvet/utils.py:98-100 returns []
    p = (os.path.join(data_root, doc["image"]) if data_root
         else doc["image"])
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results_v1(doc, response: str) -> dict:
    return {
        "question_id": doc["question_id"],
        "question": doc["question"],
        "gt_answer": doc["answer"],
        "capabilities": doc["capability"],
        "pred_answer": response,
        "score": judge_score(doc["question"], doc["answer"], response),
    }


register_task(Task(
    name="mmvet",
    doc_to_visual=doc_to_visual_v1,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results_v1,
    aggregate=lambda rs: _aggregate(rs, CAPS_V1, "mmvet"),
    primary_metric="mmvet_overall",
    load_docs=lambda data_root, split="test": __import__(
        "videoitg_tpu_torch.eval.loaders", fromlist=["load_benchmark_docs"]
    ).load_benchmark_docs("lmms-lab/MMVet", data_root, split),
    doc_id_key="question_id",
    # mmvet.yaml generation_kwargs (temperature 0.2 upstream)
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0.2,
                       "do_sample": False},
))


# ---------------------------------------------------------------------------
# v2
# ---------------------------------------------------------------------------

def _ordered_images(doc) -> List:
    return [doc[tok.strip("<>")]
            for tok in _IMAGE_TOKEN_RE.findall(doc["question"])]


def _resolve(img, data_root: str):
    """Dataset rows carry PIL images upstream; local fixtures carry
    paths — accept both (the adapter's frames_for_doc does too)."""
    import os

    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_visual_v2(doc, data_root: str = ""):
    """mmvetv2/utils.py:149-153 — images in question-token order."""
    return [_resolve(i, data_root) for i in _ordered_images(doc)]


def doc_to_visual_v2_group(doc, data_root: str = ""):
    """mmvetv2/utils.py:141-147 — one labeled composite image."""
    from PIL import Image

    imgs = []
    for i in _ordered_images(doc):
        r = _resolve(i, data_root)
        imgs.append(r.convert("RGB") if hasattr(r, "convert")
                    else Image.open(r).convert("RGB"))
    return process_images(imgs)


def replace_images_tokens(s: str) -> str:
    """mmvetv2/utils.py:156-164 with interleaved_format: false (the
    vendored config): only the <IMG> separators are dropped; the
    <image_N> tokens stay in the prompt."""
    return "".join(s.split("<IMG>"))


def doc_to_text_v2(doc, pre_prompt: str = PRE_PROMPT,
                   post_prompt: str = "") -> str:
    return f"{pre_prompt}{replace_images_tokens(doc['question'])}{post_prompt}"


def process_results_v2(doc, response: str) -> dict:
    capability = doc["capability"]
    return {
        "question_id": doc["id"],
        "question": doc["question"],
        "gt_answer": doc["answer"],
        "capabilities": (list(capability)
                         if not isinstance(capability, str)
                         else capability.split(",")),
        "pred_answer": response,
        "score": judge_score(doc["question"], doc["answer"], response),
    }


# --- composite-image construction (mmvetv2/utils.py:14-147) ---------------

def _font(size: int):
    from PIL import ImageFont

    try:  # the reference vendors arial.ttf; PIL's default is the stand-in
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: no size arg
        return ImageFont.load_default()


def add_order_label(image, label: str, font_size: int = 40):
    from PIL import ImageDraw

    draw = ImageDraw.Draw(image)
    margin = 10
    bg = (font_size + 2 * margin, font_size + 2 * margin)
    draw.rectangle([(0, 0), bg], fill="white")
    draw.text((margin, margin), label, font=_font(font_size), fill="black")
    return image


def _resize_h(image, fixed: int):
    w, h = image.size
    from PIL import Image

    return image.resize((int(w * fixed / h), fixed),
                        Image.Resampling.LANCZOS)


def _resize_w(image, fixed: int):
    w, h = image.size
    from PIL import Image

    return image.resize((fixed, int(h * fixed / w)),
                        Image.Resampling.LANCZOS)


def _concat(images, horizontal: bool):
    from PIL import Image

    ws, hs = zip(*(i.size for i in images))
    if horizontal:
        out = Image.new("RGB", (sum(ws), max(hs)))
        x = 0
        for im in images:
            out.paste(im, (x, 0))
            x += im.size[0]
    else:
        out = Image.new("RGB", (max(ws), sum(hs)))
        y = 0
        for im in images:
            out.paste(im, (0, y))
            y += im.size[1]
    return out


def process_images(images, size: int = 1008):
    """Pick the less-extreme of the labeled horizontal/vertical
    concatenations (mmvetv2/utils.py:124-138: horizontal wins when its
    w/h ratio <= the vertical's h/w ratio)."""
    horiz = _concat([add_order_label(_resize_h(im, size), f"[{i + 1}]")
                     for i, im in enumerate(images)], True)
    vert = _concat([add_order_label(_resize_w(im, size), f"[{i + 1}]")
                    for i, im in enumerate(images)], False)
    hw, hh = horiz.size
    vw, vh = vert.size
    return vert if hw / hh > vh / vw else horiz


def _load_v2(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("whyu/mm-vet-v2", data_root, split)


for _name, _visual in (("mmvetv2", doc_to_visual_v2),
                       ("mmvetv2_group_img", doc_to_visual_v2_group)):
    register_task(Task(
        name=_name,
        doc_to_visual=_visual,
        doc_to_text=doc_to_text_v2,
        doc_to_target=lambda doc: doc.get("answer"),
        process_results=process_results_v2,
        aggregate=lambda rs: _aggregate(rs, CAPS_V2, "mmvetv2"),
        primary_metric="mmvetv2_overall",
        load_docs=_load_v2,
        doc_id_key="id",
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0.2,
                           "do_sample": False},
    ))
