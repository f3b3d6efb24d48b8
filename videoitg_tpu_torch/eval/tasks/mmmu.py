"""MMMU image benchmark (parity: lmms_eval/tasks/mmmu/utils.py +
mmmu_val.yaml / mmmu_test.yaml; the answer parsers follow the official
MMMU repo code the reference vendors, utils.py:146-483).

Docs carry id (e.g. "validation_Art_12") / question (with "<image N>"
slots) / options (a STRINGIFIED python list, utils.py:47) /
question_type ("multiple-choice" | "open") / answer / image_1..image_7
(paths relative to data_root; the HF split embeds PIL).

Prompting (utils.py:44-60): multiple-choice appends the lettered option
block + the MC instruction; open questions get the single-word
instruction. interleaved_format defaults false (_default_template_yaml)
so "<image N>" tokens stay verbatim in the prompt text; the visuals list
is the sorted set of images the prompt references (utils.py:63-69).

Scoring (utils.py:200-466):
- multiple-choice: parse_multi_choice_response — candidate letters via
  "(A)" then "A " then "A." containment, content matching for long
  responses, last-occurrence tiebreak, random letter when nothing
  parses (here a crc32 of (id, response) — deterministic, documented
  divergence from utils.py:309);
- open: parse_open_response — indicator-phrase tail extraction, number
  extraction (commas/scientific/simple), normalize_str (floats rounded
  to 2dp; single chars space-padded), containment vs the normalized
  gold list.
- aggregation (utils.py:108-143): per-subdomain accuracy, per-domain
  instruction-level rollups over DOMAIN_CAT2SUB_CAT, overall
  instruction-level accuracy as the headline. mmmu_test is
  submission-only upstream (utils.py:100-105); the per-sample artifact
  is the submission.
"""

from __future__ import annotations

import ast
import re
import zlib
from collections import defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

MULTI_CHOICE_PROMPT = ("Answer with the option's letter from the given "
                       "choices directly.")
OPEN_ENDED_PROMPT = "Answer the question using a single word or phrase."

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage",
                 "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": ["Basic_Medical_Science", "Clinical_Medicine",
                            "Diagnostics_and_Laboratory_Medicine",
                            "Pharmacy", "Public_Health"],
    "Humanities and Social Science": ["History", "Literature", "Sociology",
                                      "Psychology"],
    "Tech and Engineering": ["Agriculture", "Architecture_and_Engineering",
                             "Computer_Science", "Electronics",
                             "Energy_and_Power", "Materials",
                             "Mechanical_Engineering"],
}


def _options_list(doc) -> list:
    opts = doc["options"]
    return ast.literal_eval(opts) if isinstance(opts, str) else list(opts)


def construct_prompt(doc) -> str:
    """utils.py:44-53 (interleaved_format=false keeps <image N> tokens)."""
    question = doc["question"]
    if doc["question_type"] == "multiple-choice":
        letters = [chr(ord("A") + i) for i in range(len(_options_list(doc)))]
        block = "\n".join(f"{l}. {o}"
                          for l, o in zip(letters, _options_list(doc)))
        return f"{question}\n{block}\n\n{MULTI_CHOICE_PROMPT}"
    return f"{question}\n\n{OPEN_ENDED_PROMPT}"


def doc_to_text(doc) -> str:
    return construct_prompt(doc)


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:63-69: the sorted unique <image N> slots the prompt
    references, as a list of paths (multi-image docs)."""
    import os

    prompt = construct_prompt(doc)
    tokens = sorted({t.strip("<>").replace(" ", "_")
                     for t in re.findall(r"<image \d+>", prompt)})
    paths = []
    for t in tokens:
        p = doc[t]
        p = os.path.join(data_root, p) if data_root else p
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        paths.append(p)
    return paths


def extract_subset_name(doc_id: str) -> str:
    """utils.py:89-97: "validation_Art_Theory_12" -> "Art_Theory"."""
    split = doc_id.split("_")[0]
    m = re.search(rf"^{split}_(.+?)_\d+$", doc_id)
    if not m:
        raise ValueError(f'No match found in "{doc_id}"')
    return m.group(1)


# --- official-repo answer parsing (utils.py:273-466) ---------------------

def get_multi_choice_info(options: list):
    letters = [chr(ord("A") + i) for i in range(len(options))]
    return dict(zip(letters, options)), letters


def parse_multi_choice_response(response: str, all_choices: List[str],
                                index2ans: Dict[str, str],
                                doc_id: str = "") -> str:
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "

    index_ans, ans_with_brack = True, False
    candidates = [c for c in all_choices if f"({c})" in response]
    if candidates:
        ans_with_brack = True
    if not candidates:
        candidates = [c for c in all_choices if f"{c} " in response]
    if not candidates:
        candidates = [c for c in all_choices if f"{c}." in response]
    if not candidates and len(response.split()) > 5:
        candidates = [c for c, ans in index2ans.items()
                      if ans.lower() in response.lower()]
        if candidates:
            index_ans = False
    if not candidates:
        # utils.py:309 uses random.choice; deterministic here.
        seed = zlib.crc32(f"{doc_id}|{response}".encode())
        return all_choices[seed % len(all_choices)]
    if len(candidates) == 1:
        return candidates[0]
    if index_ans and ans_with_brack:
        starts = [response.rfind(f"({c})") for c in candidates]
    elif index_ans:
        starts = [response.rfind(f" {c} ") for c in candidates]
    else:
        starts = [response.lower().rfind(index2ans[c].lower())
                  for c in candidates]
    return candidates[max(range(len(starts)), key=starts.__getitem__)]


def extract_numbers(s: str) -> List[str]:
    """utils.py:334-355: comma-grouped, scientific, then simple numbers."""
    with_commas = re.findall(r"-?\b\d{1,3}(?:,\d{3})+\b", s)
    scientific = re.findall(r"-?\d+(?:\.\d+)?[eE][+-]?\d+", s)
    simple = re.findall(r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])",
                        s)
    return with_commas + scientific + simple


def check_is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> list:
    """utils.py:371-394: floats rounded to 2dp; 1-char strings padded on
    either side so containment can't trivially match."""
    s = s.strip()
    if check_is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [" " + s, s + " "]
    return [s]


_KEY_INDICATORS = ["could be ", "so ", "is ", "thus ", "therefore ",
                   "final ", "answer ", "result "]


def parse_open_response(response: str) -> list:
    """utils.py:397-466. The response is lowered before the sentence
    split, so the reference's (?=[A-Z]) lookahead never fires — kept
    byte-identical anyway."""
    resp = response.strip().strip(".").lower()
    subs = re.split(r"\.\s(?=[A-Z])|\n", resp)
    key_responses = []
    for i, sub in enumerate(subs):
        indicators = _KEY_INDICATORS + (["="] if i == len(subs) - 1 else [])
        shortest = None
        for ind in indicators:
            if ind in sub:
                tail = sub.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in [":", ",", ".", "!", "?",
                                                 ";", "'"]:
            key_responses.append(shortest)
    if not key_responses:
        key_responses = [resp]
    preds = list(key_responses)
    for r in key_responses:
        preds.extend(extract_numbers(r))
    out = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(set(out))


def eval_multi_choice(gold, pred) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return any(g == pred for g in golds)


def eval_open(gold, preds) -> bool:
    """utils.py:218-244: normalized containment for strings, exact
    membership for numbers."""
    norm_answers = []
    for g in (gold if isinstance(gold, list) else [gold]):
        norm_answers.extend(normalize_str(g))
    for pred in preds:
        if isinstance(pred, str):
            if any(isinstance(a, str) and a in pred for a in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def process_results(doc, response: str) -> dict:
    if doc["question_type"] == "multiple-choice":
        index2ans, all_choices = get_multi_choice_info(_options_list(doc))
        parsed = parse_multi_choice_response(response, all_choices,
                                             index2ans, doc_id=doc["id"])
    else:
        parsed = parse_open_response(response)
    return {
        "id": doc["id"],
        "subdomain": extract_subset_name(doc["id"]),
        "question_type": doc["question_type"],
        "answer": doc["answer"],
        "parsed_pred": parsed,
        "prediction": response,  # submission payload (utils.py:83-85)
    }


def _is_correct(rec: dict) -> bool:
    if rec["question_type"] == "multiple-choice":
        return eval_multi_choice(rec["answer"], rec["parsed_pred"])
    return eval_open(rec["answer"], rec["parsed_pred"])


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:108-143: subdomain accs -> domain instruction-level
    rollups -> overall instruction-level acc."""
    by_sub = defaultdict(list)
    for r in records:
        by_sub[r["subdomain"]].append(float(_is_correct(r)))
    sub_acc = {s: sum(v) / len(v) for s, v in by_sub.items()}
    sub_num = {s: len(v) for s, v in by_sub.items()}

    def ins_level(subs):
        n = sum(sub_num[s] for s in subs)
        if n == 0:
            return 0.0
        return sum(sub_acc[s] * sub_num[s] for s in subs) / n

    out = {"mmmu_acc": round(ins_level(list(sub_acc)), 5)}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        present = [c for c in cats if c in sub_acc]
        if present:
            out[f"mmmu_{domain}"] = round(ins_level(present), 5)
    for s in sorted(sub_acc):
        out[f"mmmu_{s}"] = round(sub_acc[s], 5)
    return out


def _aggregate_submission(records: List[dict]) -> Dict[str, float]:
    return {"submission_rows": float(len(records))}


def _make_load_docs(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/MMMU", data_root, split_)

    return load_docs


for _name, _split, _agg, _primary in [
        ("mmmu_val", "validation", aggregate, "mmmu_acc"),
        ("mmmu_test", "test", _aggregate_submission, "submission_rows")]:
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        doc_to_target=lambda doc: doc["answer"],
        process_results=process_results,
        aggregate=_agg,
        load_docs=_make_load_docs(_split),
        doc_id_key="id",
        primary_metric=_primary,
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
    ))

register_group("mmmu", ["mmmu_val", "mmmu_test"])
