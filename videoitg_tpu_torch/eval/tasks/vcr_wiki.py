"""VCR-wiki — Visual Caption Restoration (parity:
lmms_eval/tasks/vcr_wiki/utils.py + the 12 vcr_wiki_*.yaml variants).

The model restores text that was overlaid/crossed out in an image
(vcr-org/VCR-wiki-{en,zh}-{easy,hard}-test[-100|-500], split test).
The prompt is the fixed restore instruction (per-language post_prompt
in the yamls); visuals are doc["stacked_image"].

Scoring per crossed-out blank (vcr_process_results_single,
utils.py:100-186): refusal fast-filter -> all zeros; otherwise slide a
window of width len(crossed_tokens) over the response tokens, keep
windows sharing >=1 token with the blank, pick the window with max
difflib SequenceMatcher ratio to the blank text, then score that window
(exact_match / jaccard / precision / recall / f1 / rouge1). The yaml
registers jaccard and exact_match; aggregation is the mean over every
(doc, blank) pair (utils.py:275-303; the reference's bootstrap CI +
submission JSON are side outputs of the unreturned detail dict and use
unseeded np.random — omitted).

Documented divergences (dependency-bound):
* Tokenization: the reference uses spacy en_core_web_sm /
  zh_core_web_sm (utils.py:28-43); spacy is not in this image, so en
  uses a regex word/punct tokenizer and zh falls back to per-character
  CJK tokens with latin/digit runs kept whole. Same-tokenizer scores
  are exact (the fuzz test pins the scoring math by feeding both sides
  the same tokens); absolute numbers can drift where spacy would split
  differently (contractions, zh words).
* rouge1 (reference: HF evaluate + custom tokenizer, utils.py:168-173)
  is computed in-tree as unigram clipped-overlap P/R/F1 — the same
  definition rouge_score uses with a supplied tokenizer and no stemmer.
"""

from __future__ import annotations

import re
from collections import Counter
from difflib import SequenceMatcher
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

POST_PROMPT_EN = ("What is the covered texts in the image? Please restore "
                  "the covered texts without outputting the explanations.")
POST_PROMPT_ZH = "图像中被覆盖的文本是什么？请在不输出解释的情况下还原被覆盖的文本。"

_SCORE_KEYS = ("max_sim_val", "precision", "recall", "f1", "jaccard",
               "rouge1", "exact_match")

_EN_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)
_ZH_RUN_RE = re.compile(r"[a-zA-Z0-9]+|[^\sa-zA-Z0-9]", re.UNICODE)


def fast_filter(answer_text: str) -> bool:
    """utils.py:56-68 — refusal detector."""
    if "I can't" in answer_text or "I cannot" in answer_text:
        return True
    if "sorry" in answer_text.lower():
        return True
    if "无法" in answer_text or "抱歉" in answer_text:
        return True
    return False


def tokenize(text: str, language: str) -> List[str]:
    """Stand-in for the reference's spacy tokenizers (utils.py:83-97,
    divergence documented in the module docstring)."""
    assert language in ("en", "zh")
    if language == "en":
        return _EN_TOKEN_RE.findall(text)
    return _ZH_RUN_RE.findall(text)


def _rouge1_f(pred_tokens: List[str], ref_tokens: List[str]) -> float:
    """Unigram clipped-overlap F1 (rouge_score rouge1 fmeasure with a
    supplied tokenizer, as the reference's evaluate.load("rouge") call
    resolves to)."""
    if not pred_tokens or not ref_tokens:
        return 0.0
    overlap = sum((Counter(pred_tokens) & Counter(ref_tokens)).values())
    if overlap == 0:
        return 0.0
    p = overlap / len(pred_tokens)
    r = overlap / len(ref_tokens)
    return 2 * p * r / (p + r)


_ZEROS = {k: 0 for k in _SCORE_KEYS}


def score_single(crossed_text: str, result: str, language: str) -> dict:
    """utils.py:100-186."""
    if fast_filter(result):
        return {"crossed_text": crossed_text, "max_sim_string": "",
                **_ZEROS}
    tokens_result = tokenize(result, language)
    tokens_crossed = tokenize(crossed_text, language)
    splitter = " " if language == "en" else ""
    n = len(tokens_crossed)
    crossed_set = set(tokens_crossed)
    max_sim_val, max_sim_string, max_sim_ngram = 0.0, "", []
    # nltk.util.ngrams equivalent: all width-n windows (none when the
    # response is shorter than the blank, same as the reference).
    for i in range(len(tokens_result) - n + 1):
        ngram = tokens_result[i:i + n]
        if crossed_set.isdisjoint(ngram):
            continue
        cand = splitter.join(ngram)
        sim = SequenceMatcher(None, cand, crossed_text).ratio()
        if sim > max_sim_val:
            max_sim_val, max_sim_string, max_sim_ngram = sim, cand, ngram
    if not max_sim_ngram:
        return {"crossed_text": crossed_text, "max_sim_string": "",
                **_ZEROS}
    pred_set, ref_set = set(max_sim_ngram), set(tokens_crossed)
    correct = len(pred_set & ref_set)
    precision = correct / len(pred_set)
    recall = correct / len(ref_set)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0)
    union = pred_set | ref_set
    jaccard = correct / len(union) if union else 0
    return {
        "crossed_text": crossed_text,
        "max_sim_string": max_sim_string,
        "max_sim_val": max_sim_val,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "jaccard": jaccard,
        "rouge1": _rouge1_f(tokenize(max_sim_string, language),
                            tokenize(crossed_text, language)),
        "exact_match": float(list(max_sim_ngram) == list(tokens_crossed)),
    }


def doc_to_visual(doc, data_root: str = ""):
    """utils.py:71-72."""
    return [doc["stacked_image"]]


def _make_doc_to_text(post_prompt_default: str):
    def doc_to_text(doc, pre_prompt: str = "",
                    post_prompt: str = post_prompt_default) -> str:
        """utils.py:75-80 — the prompt ignores the doc."""
        return f"{pre_prompt}{post_prompt}"
    return doc_to_text


def _make_process(language: str):
    def process_results(doc, response: str) -> dict:
        """utils.py:189-251 — one score set per crossed-text blank."""
        return {"question_id": doc.get("question_id"),
                "blanks": [score_single(ct, response, language)
                           for ct in doc["crossed_text"]]}
    return process_results


def aggregate(records: List[dict]) -> Dict[str, float]:
    """utils.py:275-303 — mean over every (doc, blank) pair for the two
    yaml-registered metrics (+ the other scores, free to report)."""
    out = {}
    for key in ("exact_match", "jaccard", "f1", "precision", "recall",
                "rouge1"):
        vals = [b[key] for r in records for b in r["blanks"]]
        out[f"vcr_{key}"] = sum(vals) / len(vals) if vals else 0.0
    return {"vcr_exact_match": out.pop("vcr_exact_match"), **out}


_GEN = {"max_new_tokens": 120, "temperature": 0, "top_p": 0,
        "do_sample": False}

for _lang, _post in (("en", POST_PROMPT_EN), ("zh", POST_PROMPT_ZH)):
    for _difficulty in ("easy", "hard"):
        for _size in ("", "_100", "_500"):
            _hub = (f"vcr-org/VCR-wiki-{_lang}-{_difficulty}-test"
                    + _size.replace("_", "-"))

            def _make_load(hub=_hub):
                def load_docs(data_root: str,
                              split: str = "test") -> List[dict]:
                    from videoitg_tpu_torch.eval.loaders import \
                        load_benchmark_docs

                    return load_benchmark_docs(hub, data_root, split)
                return load_docs

            register_task(Task(
                name=f"vcr_wiki_{_lang}_{_difficulty}{_size}",
                doc_to_visual=doc_to_visual,
                doc_to_text=_make_doc_to_text(_post),
                doc_to_target=lambda doc: doc.get("caption", ""),
                process_results=_make_process(_lang),
                aggregate=aggregate,
                primary_metric="vcr_exact_match",
                load_docs=_make_load(),
                generation_kwargs=dict(_GEN),
            ))
