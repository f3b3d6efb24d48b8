"""MM-UPD — Unsolvable Problem Detection (parity:
lmms_eval/tasks/mmupd/utils.py + mmupd_evals.py + the 9 task yamls).

Nine tasks over MM-UPD/MM-UPD: mm{aad,iasd,ivqd}_{base,option,
instruction} (AAD = absent-answer detection, IASD = incompatible-answer-
set detection, IVQD = incompatible-visual-question detection; base/
option/inst are the question formulations). Docs are mmbench-shaped
(index / A-E options / question / hint / answer / category / source /
split) plus type ("standard" | "upd") and masked_answer (the ground
truth the UPD variant hid). Rotated circular copies share index % 1e6.

Prompting (utils.py:46-69): hint + question + sorted present options
(create_options_prompt with empty sys_prompt per the shipped yamls) +
post_prompt "\\n".

Scoring is DUAL circular evaluation (mmupd_evals.py:464-620):
* standard accuracy over type=="standard" rotations, upd accuracy over
  type=="upd" rotations — each a per-base-index all-rotations-correct
  bit (eval_sub_data): prefetch via the UPD letter extractor
  (can_infer_option, evals.py:329-390 — answer starts with "X)/X./X,/
  (X)" and mentions no other lettered option; valid letters grow to F/G
  for the appended gt/none options); unresolved predictions go to the
  judge with the answer-matching prompt built over the option list
  EXTENDED with the masked gt and the type-specific none-option
  (build_option_str_w_gt, evals.py:144-257; build_prompt,
  evals.py:259-326 — verbatim constants); a judge that never yields a
  valid letter scores "H" (evals.py:461-462). For upd rotations the
  prediction is correct when it hits the gold letter OR any
  answer_option (the appended gt/none letters; gold "F" must hit an
  answer_option, evals.py:485-494).
* dual accuracy: a base index scores 1 iff BOTH its standard and upd
  bits are 1 (calculate_dual_acc, evals.py:600-620). The task metric is
  overall_acc_dual * 100 (utils.py:142-167), with standard/upd overall
  and per-category rates reported alongside.

Divergences (documented): the judge retry loop uses the pluggable
judge backend at its own temperature instead of raw OpenAI POSTs with
temperature=0.7 (evals.py:409-448); rd.seed(2680) (evals.py:519) seeds
a generator the eval path never draws from — omitted.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge

OPTION_CANDIDATES = ("A", "B", "C", "D", "E")

_AAD_NONE_TEXT = ("The correct answer is No answer, None of the above, \
                    all provided options are incorrect, or I cannot answer.")
# evals.py:201-215 single-line vs evals.py:225-226 wrapped (the
# reference's line continuation embeds 20 spaces into the standard-
# branch string; both preserved byte-for-byte).
_IASD_NONE_TEXT = ("The correct answer is No answer, None of the above, "
                   "all provided options are irrelevant or incorrect, or "
                   "I cannot answer.")
_IASD_NONE_TEXT_WRAPPED = ("The correct answer is No answer, None of the above, \
                    all provided options are irrelevant or incorrect, or I cannot answer.")
_IVQD_NONE_TEXT = ("The correct answer is that The image is incompatible "
                   "with the question, or I cannot answer.")


def _is_none_value(value) -> bool:
    """evals.py:100-111."""
    if value is None:
        return True
    if isinstance(value, float):
        import math

        if math.isnan(value):
            return True
    if isinstance(value, str) and value.lower() in ("nan", "none"):
        return True
    return False


def create_options_prompt(doc: dict, sys_prompt: str = "") -> Tuple[str, dict]:
    """evals.py:90-98 (sys_prompt is "" in every shipped yaml)."""
    options = {c: doc[c] for c in OPTION_CANDIDATES
               if c in doc and doc[c] and not _is_none_value(doc[c])}
    sorted_options = dict(sorted(options.items()))
    prompt = f"{sys_prompt}\n"
    for key, item in sorted_options.items():
        prompt += f"{key}. {item}\n"
    return prompt.rstrip("\n"), sorted_options


def doc_to_text(doc, post_prompt: str = "\n") -> str:
    """utils.py:46-69."""
    options_prompt, _ = create_options_prompt(doc)
    hint = doc.get("hint")
    if not _is_none_value(hint) and hint != "":
        query = f"{hint}\n{doc['question']}{options_prompt}"
    else:
        query = f"{doc['question']}{options_prompt}"
    return f"{query}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:42-43 — base64-encoded image bytes."""
    img = doc.get("image")
    if hasattr(img, "convert"):
        return img
    import base64
    import io

    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(img)))


def extract_options(doc: dict) -> List[str]:
    """evals.py:124-132."""
    return [doc[c] for c in OPTION_CANDIDATES
            if c in doc and not _is_none_value(doc[c])]


def build_choices(doc: dict) -> Dict[str, str]:
    """evals.py:134-142."""
    return {c: doc[c] for c in OPTION_CANDIDATES
            if c in doc and not _is_none_value(doc[c])}


def build_option_str_w_gt(option_list: List[str], gt_text,
                          eval_type: str, question_type: str,
                          upd_type: str):
    """evals.py:144-257 — append the masked gt and/or the type-specific
    none-option after the real options; returns (option_str,
    valid_option letters, answer_option letters)."""
    import string

    s = "There are several options: \n"
    valid_option: List[str] = []
    answer_option: List[str] = []
    for c, opt in zip(string.ascii_uppercase, option_list):
        if not _is_none_value(opt):
            s += f"{c}. {opt}\n"
            valid_option.append(c)

    def first_free() -> str:
        for option in ("C", "D", "E", "F"):
            if option not in valid_option:
                return option
        return ""

    if upd_type == "aad":
        if eval_type == "aad":
            gt_option = first_free()
            none_mapping = {"C": "D", "D": "E", "E": "F", "F": "G"}
            s += f"{gt_option}. {gt_text}\n"
            none_option = none_mapping[gt_option]
            s += f"{none_option}. {_AAD_NONE_TEXT}\n"
            valid_option += [gt_option, none_option]
            answer_option = [gt_option, none_option]
            if question_type == "inst":
                s += "F. None of the above\n"
                valid_option.append("F")
                answer_option = [gt_option, none_option, "F"]
        if eval_type == "standard":
            none_option = first_free()
            s += f"{none_option}. {_AAD_NONE_TEXT}\n"
            valid_option.append(none_option)
            if question_type == "inst":
                s += "F. None of the above\n"
                valid_option.append("F")
    elif upd_type == "iasd":
        if eval_type == "iasd":
            gt_option = first_free()
            s += f"{gt_option}. {gt_text}\n"
            valid_option.append(gt_option)
            if question_type == "inst":
                if gt_option == "E":
                    s += "F. None of the above\n"
                    valid_option.append("F")
                    s += f"G. {_IASD_NONE_TEXT}\n"
                    valid_option.append("G")
                    answer_option = [gt_option, "F", "G"]
                else:
                    none_option = {"C": "D", "D": "E"}[gt_option]
                    s += f"{none_option}. {_IASD_NONE_TEXT}\n"
                    valid_option.append(none_option)
                    s += "F. None of the above\n"
                    valid_option.append("F")
                    answer_option = [gt_option, none_option, "F"]
            else:
                none_option = {"C": "D", "D": "E", "E": "F",
                               "F": "G"}[gt_option]
                s += f"{none_option}. {_IASD_NONE_TEXT}\n"
                valid_option.append(none_option)
                answer_option = [gt_option, none_option]
        if eval_type == "standard":
            none_option = first_free()
            s += f"{none_option}. {_IASD_NONE_TEXT_WRAPPED}\n"
            valid_option.append(none_option)
            if question_type == "inst":
                s += "F. None of the above\n"
                valid_option.append("F")
    elif upd_type == "ivqd":
        if eval_type == "ivqd":
            none_option = first_free()
            s += f"{none_option}. {_IVQD_NONE_TEXT}\n"
            valid_option.append(none_option)
            answer_option = [none_option]
            if question_type == "inst":
                s += "F. The image and question are irrelevant.\n"
                valid_option.append("F")
                answer_option = [none_option, "F"]
        if eval_type == "standard":
            none_option = first_free()
            s += f"{none_option}. {_IVQD_NONE_TEXT}\n"
            valid_option.append(none_option)
            if question_type == "inst":
                s += "F. The image and question are irrelevant.\n"
                valid_option.append("F")
    return s, valid_option, answer_option


# evals.py:259-326 — verbatim judge-matching prompt templates (aad and
# iasd share one; ivqd swaps the example wording).
_MATCH_TMPL_COMMON = (
    "You are an AI assistant who will help me to match an answer "
    "with several options of a single-choice question. "
    "You are provided with a question, several options, and an answer, "
    "and you need to find which option is most similar to the answer. "
    "If the meaning of all options are significantly different "
    "from the answer, output H. "
    "Your should output a single uppercase character in A, B, C, D, E, F, G "
    "(if they are valid options), and H. \n"
    "Example 1: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. no answer \nAnswer: a cute teddy bear\nYour output: A\n"
    "Example 2: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. None of the above  \nAnswer: no answer \nYour output: E\n"
    "Example 3: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. None of the above \nAnswer: fish \nYour output: H\n"
    "Example 4: \n"
    "Question: {}?\nOptions: {}\nAnswer: {}\nYour output: "
)

_MATCH_TMPL_IVQD = (
    "You are an AI assistant who will help me to match an answer "
    "with several options of a single-choice question. "
    "You are provided with a question, several options, and an answer, "
    "and you need to find which option is most similar to the answer. "
    "If the meaning of all options are significantly different "
    "from the answer, output H. "
    "Your should output a single uppercase character in A, B, C, D, E, F, G "
    "(if they are valid options), and H. \n"
    "Example 1: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. The image and question are irrelevant \nAnswer: a cute teddy bear\nYour output: A\n"
    "Example 2: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. The image and question are irrelevant \nAnswer: The updloaded image and question are incompatible. \nYour output: E\n"
    "Example 3: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog E. The image and question are irrelevant \nAnswer: fish \nYour output: H\n"
    "Example 4: \n"
    "Question: {}?\nOptions: {}\nAnswer: {}\nYour output: "
)


def build_prompt(question: str, options: str, prediction: str,
                 upd_type: str) -> str:
    tmpl = _MATCH_TMPL_IVQD if upd_type == "ivqd" else _MATCH_TMPL_COMMON
    return tmpl.format(question, options, prediction)


def can_infer_option(answer: str, option_dict: Dict[str, str],
                     question_type: Optional[str] = None,
                     valid_option: Optional[List[str]] = None):
    """evals.py:329-390."""
    if valid_option is None:
        valid_option = list(option_dict.keys())
        if question_type == "inst":
            valid_option.append("F")
    if "Failed to obtain answer via API" in answer:
        return False
    answer = answer.strip()
    all_letters = ["A", "B", "C", "D", "E", "F", "G"]
    punctuations = [".", ")", ","]
    candidates = []
    for ch in all_letters:
        if ch not in valid_option:
            continue
        others = [c for c in all_letters if c != ch]
        combos = [c + p for c in others for p in punctuations]
        starts = [f"{ch})", f"{ch}.", f"{ch},", f"({ch})"]
        if answer == ch or (any(answer.startswith(s) for s in starts)
                            and all(x not in answer for x in combos)):
            candidates.append(ch)
    if len(candidates) == 1:
        return candidates[0]
    return False


def can_infer(answer: str, choices: Dict[str, str],
              question_type: Optional[str] = None,
              valid_option: Optional[List[str]] = None):
    """evals.py:392-394."""
    copt = can_infer_option(answer, choices, question_type,
                            valid_option=valid_option)
    return copt if copt else False


def extract_answer_from_item(item: dict, gt_text, eval_type: str,
                             question_type: str, upd_type: str):
    """evals.py:435-462 — prefetch against the EXTENDED option set, then
    up to 3 judge passes, then 'H'."""
    options = extract_options(item)
    option_str, valid_option, answer_option = build_option_str_w_gt(
        options, gt_text, eval_type, question_type=question_type,
        upd_type=upd_type)
    prompt = build_prompt(item["question"], option_str,
                          item["prediction"], upd_type=upd_type)
    choices = build_choices(item)
    ret = can_infer(item["prediction"], choices, valid_option=valid_option)
    if ret:
        return ret, item["prediction"], answer_option
    judge = get_judge()
    for _ in range(3):
        try:
            ans = judge([{"role": "user", "content": prompt}],
                        max_tokens=256)
        except Exception:
            continue
        ret = can_infer(ans, choices, valid_option=valid_option)
        if ret:
            return ret, ans, answer_option
    return "H", "Failed to predict. ", answer_option


def prefetch_answer(item: dict, question_type: str):
    """evals.py:396-398."""
    return can_infer(item["prediction"], build_choices(item),
                     question_type=question_type)


def eval_sub_data(sub_data: List[dict], answer_map: Dict,
                  gt_text_map: Dict, question_type: str, eval_type: str,
                  upd_type: str) -> int:
    """evals.py:464-495 — all rotations must be correct."""
    GT, PRED = [], []
    for item in sub_data:
        GT.append(answer_map[item["index"]])
        PRED.append(prefetch_answer(item, question_type))
        if PRED[-1] and GT[-1] != PRED[-1]:
            return 0
    for i, item in enumerate(sub_data):
        if PRED[i]:
            continue
        gt_text = gt_text_map.get(item["index"]) if gt_text_map else None
        ret, _, answer_option = extract_answer_from_item(
            item, gt_text, eval_type, question_type=question_type,
            upd_type=upd_type)
        PRED[i] = ret
        if eval_type == "standard":
            if PRED[i] != GT[i]:
                return 0
        else:
            if GT[i] == "F":
                if PRED[i] not in answer_option:
                    return 0
            else:
                if PRED[i] != GT[i] and PRED[i] not in answer_option:
                    return 0
    return 1


def process_results(doc, response: str) -> dict:
    """utils.py:72-102 — carry everything the dual evaluator needs."""
    rec = {"index": doc["index"], "question": doc["question"],
           "answer": doc.get("answer"), "prediction": response.strip(),
           "hint": doc.get("hint"), "source": doc.get("source"),
           "split": doc.get("split"), "category": doc.get("category"),
           "type": doc["type"], "masked_answer": doc.get("masked_answer")}
    for c in OPTION_CANDIDATES:
        rec[c] = doc.get(c, "nan")
    return rec


def _eval_one_type(records: List[dict], upd_type: str,
                   question_type: str, eval_type: str) -> Dict[int, int]:
    """evals.py:508-576 — per-base-index hit bits for one eval_type."""
    want = "standard" if eval_type == "standard" else "upd"
    data = [r for r in records if r["type"] == want]
    answer_map = {r["index"]: r["answer"] for r in data}
    gt_text_map = {r["index"]: r["masked_answer"] for r in data}
    by_base: Dict[int, List[dict]] = defaultdict(list)
    for r in data:
        by_base[int(r["index"]) % int(1e6)].append(r)
    hits: Dict[int, int] = {}
    for base, sub in sorted(by_base.items()):
        if not any(r["index"] == base for r in sub):
            continue  # rotations without their base never score upstream
        sub = sorted(sub, key=lambda r: r["index"])
        hits[base] = eval_sub_data(sub, answer_map, gt_text_map,
                                   question_type=question_type,
                                   eval_type=eval_type, upd_type=upd_type)
    return hits


def _make_aggregate(upd_type: str, question_type: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        """utils.py:142-167 + evals.py:497-620."""
        if not records:
            return {"gpt_eval_score": 0.0}
        std = _eval_one_type(records, upd_type, question_type, "standard")
        upd = _eval_one_type(records, upd_type, question_type, upd_type)
        cate = {int(r["index"]) % int(1e6): (r.get("category")
                                             or "uncategorized")
                for r in records}
        dual = {b: int(std.get(b, 0) == 1 and upd.get(b, 0) == 1)
                for b in set(std) | set(upd)}

        def rates(hits: Dict[int, int]) -> Dict[str, float]:
            if not hits:
                return {"overall": 0.0}
            out = {"overall": sum(hits.values()) / len(hits)}
            by_cat: Dict[str, list] = defaultdict(list)
            for b, h in hits.items():
                by_cat[cate[b]].append(h)
            for c, v in sorted(by_cat.items()):
                out[c] = sum(v) / len(v)
            return out

        dual_rates = rates(dual)
        out = {"gpt_eval_score": dual_rates["overall"] * 100,
               "overall_acc_standard": rates(std)["overall"],
               "overall_acc_upd": rates(upd)["overall"],
               "overall_acc_dual": dual_rates["overall"]}
        for c, v in dual_rates.items():
            if c != "overall":
                out[f"dual_{c}"] = v
        return out
    return aggregate


def _make_load(subset: str):
    def load_docs(data_root: str, split: str = "test") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("MM-UPD/MM-UPD", data_root, split,
                                   subset=subset)
    return load_docs


_GEN = {"max_new_tokens": 1024, "temperature": 0, "top_p": 0,
        "do_sample": False, "until": ["ASSISTANT:"]}

_TASKS = []
for _upd, _upd_slug in (("aad", "mmaad"), ("iasd", "mmiasd"),
                        ("ivqd", "mmivqd")):
    for _qt, _qt_slug in (("base", "base"), ("option", "option"),
                          ("inst", "instruction")):
        _name = f"{_upd_slug}_{_qt_slug}"
        _TASKS.append(_name)
        register_task(Task(
            name=_name,
            doc_to_visual=doc_to_visual,
            doc_to_text=doc_to_text,
            doc_to_target=lambda doc: str(doc.get("answer", "")),
            process_results=process_results,
            aggregate=_make_aggregate(_upd, _qt),
            primary_metric="gpt_eval_score",
            load_docs=_make_load(_name),
            doc_id_key="index",
            generation_kwargs=dict(_GEN),
        ))

register_group("mmupd", list(_TASKS))
register_group("mmupd_base", ["mmaad_base", "mmiasd_base", "mmivqd_base"])
register_group("mmupd_option", ["mmaad_option", "mmiasd_option",
                                "mmivqd_option"])
register_group("mmupd_instruction", ["mmaad_instruction",
                                     "mmiasd_instruction",
                                     "mmivqd_instruction"])
