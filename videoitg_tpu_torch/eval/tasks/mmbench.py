"""MMBench image benchmark family (parity: lmms_eval/tasks/mmbench/
{en,cn,cc,ru}_utils.py + mmbench_evals.py + the yamls).

Six tasks over the reference's splits: mmbench_en_dev, mmbench_en_test,
mmbench_cn_dev, mmbench_cn_test, mmbench_cn_cc, mmbench_ru_dev. Docs
carry index / image / question / A-E option columns / answer (dev only) /
hint / category / L2-category ("l2-category" in the ru dataset) /
source / split.

Prompting parity (en_utils.py:43-66, mmbench_evals.py:22-30):
- options block: "There are several options:" then "K. text" for each of
  A-E present, truthy, not NaN and not the literal string "nan", sorted
  by letter (create_options_prompt);
- query = "{hint} {question} {options}" when the hint is valid else
  "{question} {options}", plus the per-language post_prompt on its own
  line. Hint validity: en/ru also reject the literal "nan" string
  (en_utils.py:61 vs cn_utils.py:61); cc has no hint at all
  (cc_utils.py:57).

Scoring parity — MMBench circular evaluation (mmbench_evals.py:202-320):
rotated copies of a question share ``index % 1e6``; a base question
(index < 1e6) scores 1 only if EVERY rotation's prediction resolves to
the gold letter. Per rotation, resolution is:
1. prefetch: ``can_infer`` = exact option-letter detection over
   whitespace splits (bare letter, then the 12 punctuation wrappings,
   with the "A might be a quantifier" guard, mmbench_evals.py:81-107)
   falling back to unique option-TEXT containment (can_infer_text);
2. unresolvable predictions go to the judge with the reference's
   answer-matching prompt (mmbench_evals.py:59-78, 3 retries);
3. if the judge never yields a parseable letter the reference draws a
   random letter (rd.seed(2680), mmbench_evals.py:192-199); here the
   draw is a crc32 of (index, prediction) so reruns are deterministic —
   documented divergence, same letter distribution.

Aggregation (eval_result + calculate_hit_rates, mmbench_evals.py:223-320):
overall hit rate *100 plus per-category and per-L2-category rates. The
reference's second "submission" metric (an xlsx of the raw records) is
covered by the harness's per-sample artifacts. Test splits ship no
answers upstream (submission-only); their aggregate reports the record
count so the samples jsonl IS the submission.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge

SYS_PROMPT = "There are several options:"  # mmbench.yaml metadata
OPTION_CANDIDATES = ("A", "B", "C", "D", "E")

# mmbench_evals.py:101 — the 12 punctuation wrappings tried after bare
# letters, in order.
_WRAPPINGS = [("", "."), ("", ","), ("", ":"), ("", ")"), ("", ")."),
              ("(", ")"), ("(", ")."), (":", ""), (":", ","), (":", "."),
              (":", ")"), (":", ").")]

JUDGE_PROMPT_TEMPLATE = (
    "You are an AI assistant who will help me to match an answer "
    "with several options of a single-choice question. "
    "You are provided with a question, several options, and an answer, "
    "and you need to find which option is most similar to the answer. "
    "If the meaning of all options are significantly different "
    "from the answer, output E. "
    "Your should output a single uppercase character in A, B, C, D "
    "(if they are valid options), and E. \n"
    "Example 1: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog\nAnswer: a cute teddy bear\nYour output: A\n"
    "Example 2: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog\nAnswer: Spider\nYour output: E\n"
    "Example 3: \n"
    "Question: {}?\nOptions: {}\nAnswer: {}\nYour output: "
)  # mmbench_evals.py:60-77 verbatim


def _notna(v) -> bool:
    """pd.notna semantics for scalars: None and float NaN are na."""
    if v is None:
        return False
    if isinstance(v, float) and v != v:
        return False
    return True


def create_options_prompt(doc: dict) -> str:
    """mmbench_evals.py:22-30: A-E present AND truthy, sorted; rows that
    are NaN or the literal "nan" are skipped inside the loop."""
    options = {c: doc[c] for c in OPTION_CANDIDATES
               if c in doc and doc[c]}
    out = f"{SYS_PROMPT}\n"
    for key in sorted(options):
        item = options[key]
        if _notna(item) and item != "nan":
            out += f"{key}. {item}\n"
    return out.rstrip("\n")


def _hint_valid(doc: dict, strict_nan: bool) -> bool:
    hint = doc.get("hint")
    if not _notna(hint):
        return False
    return not (strict_nan and hint == "nan")


def _make_doc_to_text(post_prompt_default: str, with_hint: bool,
                      strict_nan: bool):
    def doc_to_text(doc, post_prompt: str = post_prompt_default) -> str:
        options = create_options_prompt(doc)
        if with_hint and _hint_valid(doc, strict_nan):
            query = f"{doc['hint']} {doc['question']} {options}"
        else:
            query = f"{doc['question']} {options}"
        if post_prompt:
            query = f"{query}\n{post_prompt}"
        return query

    return doc_to_text


def doc_to_visual(doc, data_root: str = ""):
    import os

    p = os.path.join(data_root, doc["image"]) if data_root else doc["image"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    """One record per rotation carrying everything eval_result needs
    (en_utils.py:69-99; the reference emits the same dict twice for the
    gpt_eval_score and submission metrics)."""
    rec = {
        "index": doc["index"],
        "question": doc["question"],
        "answer": doc.get("answer"),
        "prediction": str(response).strip(),
        "category": doc.get("category"),
        "l2-category": doc.get("L2-category", doc.get("l2-category")),
        "source": doc.get("source"),
        "split": doc.get("split"),
        "hint": doc.get("hint"),
    }
    for c in OPTION_CANDIDATES:
        rec[c] = doc.get(c, "nan")
    return rec


# --- answer inference (mmbench_evals.py:81-125) -------------------------

def can_infer_option(answer: str, num_choice: int = 5) -> Optional[str]:
    choices = "ABCDE"[:num_choice]
    if "Failed to obtain answer via API" in answer:
        return None

    splits = [x.strip() for x in answer.split()]

    def count(prefix: str = "", suffix: str = "") -> int:
        return sum(1 for c in choices if prefix + c + suffix in splits)

    if count() == 1:
        for ch in choices:
            if "A" in splits and len(splits) > 3:
                # "A might be a quantifier in the string" guard
                # (mmbench_evals.py:96-98) — falls through to wrappings.
                break
            if ch in splits:
                return ch
    for prefix, suffix in _WRAPPINGS:
        if count(prefix, suffix) == 1:
            for ch in choices:
                if prefix + ch + suffix in splits:
                    return ch
    return None


def can_infer_text(answer: str, choices: Dict[str, str]) -> Optional[str]:
    answer = answer.lower()
    cands = [k for k, v in choices.items() if str(v).lower() in answer]
    return cands[0] if len(cands) == 1 else None


def can_infer(answer: str, choices: Dict[str, str]) -> Optional[str]:
    return can_infer_option(answer) or can_infer_text(answer, choices)


def _build_choices(rec: dict) -> Dict[str, str]:
    """mmbench_evals.py:52-57: ABCD rows that are not na."""
    return {c: rec[c] for c in "ABCD"
            if _notna(rec.get(c)) and rec.get(c) != "nan"}


def _build_option_str(rec: dict) -> str:
    """extract_options + build_option_str (mmbench_evals.py:33-50):
    options accumulate A..D until the first missing/na entry."""
    s = "There are several options: \n"
    for c in "ABCD":
        v = rec.get(c)
        if _notna(v) and v != "nan":
            s += f"{c}. {v}\n"
        else:
            break
    return s


def extract_answer(rec: dict, judge=None) -> Optional[str]:
    """mmbench_evals.py:166-199 with the judge backend standing in for
    the raw GPT POST; the terminal random draw is crc32-deterministic."""
    choices = _build_choices(rec)
    ret = can_infer(rec["prediction"], choices)
    if ret:
        return ret
    judge = judge or get_judge()
    prompt = JUDGE_PROMPT_TEMPLATE.format(
        rec["question"], _build_option_str(rec), rec["prediction"])
    for _ in range(3):
        ans = judge([{"role": "user", "content": prompt}], max_tokens=256)
        ret = can_infer(ans, choices)
        if ret:
            return ret
    num_options = len(choices)
    if num_options >= 2:
        chars = "ABCD"[:num_options] + "E"
        seed = zlib.crc32(f"{rec['index']}|{rec['prediction']}".encode())
        return chars[seed % len(chars)]
    return None


def _eval_sub_data(sub: List[dict], answer_map: Dict, judge=None) -> int:
    """Circular-group scoring (mmbench_evals.py:202-221): every rotation
    must resolve to its gold letter; prefetch first, judge the rest."""
    preds = []
    for rec in sub:
        pred = can_infer(rec["prediction"], _build_choices(rec))
        gt = answer_map[rec["index"]]
        if pred and pred != gt:
            return 0
        preds.append(pred)
    for rec, pred in zip(sub, preds):
        if pred:
            continue
        if extract_answer(rec, judge=judge) != answer_map[rec["index"]]:
            return 0
    return 1


def _aggregate_dev(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        records = sorted(records, key=lambda r: r["index"])
        answer_map = {r["index"]: r["answer"] for r in records}
        judge = get_judge()
        groups = defaultdict(list)
        for r in records:
            groups[int(r["index"]) % int(1e6)].append(r)
        hits = {}  # base index -> 0/1
        for r in records:
            idx = int(r["index"])
            if idx < int(1e6):
                hits[idx] = _eval_sub_data(groups[idx], answer_map, judge)
        if not hits:
            return {prefix: 0.0}
        by_cat, by_l2 = defaultdict(list), defaultdict(list)
        for r in records:
            idx = int(r["index"])
            if idx not in hits:
                continue
            if r.get("category") is not None:
                by_cat[r["category"]].append(hits[idx])
            if r.get("l2-category") is not None:
                by_l2[r["l2-category"]].append(hits[idx])
        out = {prefix: 100.0 * sum(hits.values()) / len(hits)}
        for cat in sorted(by_cat):
            out[f"{prefix}_{cat}"] = sum(by_cat[cat]) / len(by_cat[cat])
        for cat in sorted(by_l2):
            out[f"{prefix}_l2_{cat}"] = sum(by_l2[cat]) / len(by_l2[cat])
        return out

    return aggregate


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    # Test splits are submission-only upstream (en_utils.py:124-129);
    # the samples jsonl written by the harness is the submission.
    return {"submission_rows": float(len(records))}


def _make_load_docs(dataset_id: str, subset: Optional[str], split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs(dataset_id, data_root, split_,
                                   subset=subset)

    return load_docs


EN_POST = "\nAnswer with the option's letter from the given choices directly."
CN_POST = "\n请直接使用所提供的选项字母作为答案回答。"
RU_POST = "\nВыбери правильный вариант ответа буквой."

# (name, dataset_id, subset, split, post, with_hint, strict_nan,
#  max_new_tokens, dev?)
_VARIANTS = [
    ("mmbench_en_dev", "lmms-lab/MMBench", "en", "dev",
     EN_POST[1:], True, True, 1024, True),
    ("mmbench_en_test", "lmms-lab/MMBench", "en", "test",
     EN_POST[1:], True, True, 1024, False),
    ("mmbench_cn_dev", "lmms-lab/MMBench", "cn", "dev",
     CN_POST[1:], True, False, 256, True),
    ("mmbench_cn_test", "lmms-lab/MMBench", "cn", "test",
     CN_POST[1:], True, False, 256, False),
    ("mmbench_cn_cc", "lmms-lab/MMBench", "cc", "test",
     CN_POST[1:], False, False, 256, True),
    ("mmbench_ru_dev", "deepvk/MMBench-ru", None, "dev",
     RU_POST[1:], True, True, 1024, True),
]

for (_name, _ds, _subset, _split, _post, _hint, _strict, _mnt,
     _dev) in _VARIANTS:
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_make_doc_to_text(_post, _hint, _strict),
        doc_to_target=lambda doc: doc.get("answer", ""),
        process_results=process_results,
        aggregate=(_aggregate_dev(_name) if _dev else _aggregate_submission),
        load_docs=_make_load_docs(_ds, _subset, _split),
        doc_id_key="index",
        primary_metric=(_name if _dev else "submission_rows"),
        generation_kwargs=(
            # en/ru yamls add until ["ASSISTANT:"] (mmbench_en_dev.yaml);
            # cn/cc do not (_default_template_mmbench_cn_yaml).
            {"max_new_tokens": _mnt, "temperature": 0, "do_sample": False,
             **({"until": ["ASSISTANT:"]} if _mnt == 1024 else {})}),
    ))

register_group("mmbench", [v[0] for v in _VARIANTS])
register_group("mmbench_en", ["mmbench_en_dev", "mmbench_en_test"])
register_group("mmbench_cn",
               ["mmbench_cn_dev", "mmbench_cn_test", "mmbench_cn_cc"])
