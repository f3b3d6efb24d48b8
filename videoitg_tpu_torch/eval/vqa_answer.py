"""VQA-v2 answer normalization ("EvalAI answer processor").

Parity: lmms_eval/tasks/_task_utils/vqa_eval_metric.py (the reference
vendors the mmf/pythia EvalAIAnswerProcessor). The contraction / number /
punctuation tables below ARE the metric definition — the official VQA
accuracy is computed over answers normalized with exactly these tables,
so they are kept verbatim, including the upstream quirks:

- ``"somebody'd": "somebodyd"`` is reversed relative to every other
  entry (vqa_eval_metric.py:66) — kept bug-for-bug.
- ``PERIOD_STRIP`` is ``(?!<=\\d)(\\.)(?!\\d)``: the author clearly meant
  a negative LOOKBEHIND ``(?<!\\d)`` but wrote a negative lookahead of
  the literal text ``<=\\d`` (always true), so the net behavior is
  "strip any period not followed by a digit" — kept bug-for-bug.
- upstream's ``process_digit_article`` uses ``NUMBER_MAP.setdefault``,
  mutating a class-level dict with identity entries; the lookup result
  is identical to ``.get(word, word)``, which is what we do (no output
  difference, no cross-call state).

The VQA leave-one-out accuracy (min(1, matches/3) averaged over the 10
annotators) lives with the tasks that use it (textvqa, vqav2-style).
"""

from __future__ import annotations

import re
import statistics
from typing import Sequence

# vqa_eval_metric.py:12-136 — verbatim parity table.
CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

# vqa_eval_metric.py:138-150
NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = ("a", "an", "the")
# vqa_eval_metric.py:152-153 — see module docstring for the PERIOD_STRIP quirk.
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
PUNCTUATIONS = (
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
)


def _word_tokenize(word: str) -> str:
    # vqa_eval_metric.py:178-181
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def _process_punctuation(in_text: str) -> str:
    # vqa_eval_metric.py:183-191: a punctuation char adjacent to a space
    # (or any text containing a digit,comma,digit run) is deleted; one
    # embedded in a word is replaced by a space.
    out_text = in_text
    for p in PUNCTUATIONS:
        if ((p + " " in in_text or " " + p in in_text)
                or _COMMA_STRIP.search(in_text) is not None):
            out_text = out_text.replace(p, "")
        else:
            out_text = out_text.replace(p, " ")
    # upstream passes re.UNICODE (==32) as Pattern.sub's positional
    # *count* arg (vqa_eval_metric.py:190), capping the strip at 32
    # periods — kept bug-for-bug.
    out_text = _PERIOD_STRIP.sub("", out_text, 32)
    return out_text


def _process_digit_article(in_text: str) -> str:
    # vqa_eval_metric.py:193-206: number words -> digits, drop articles,
    # then canonicalize contractions.
    out_text = []
    for word in in_text.lower().split():
        word = NUMBER_MAP.get(word, word)
        if word not in ARTICLES:
            out_text.append(word)
    for i, word in enumerate(out_text):
        if word in CONTRACTIONS:
            out_text[i] = CONTRACTIONS[word]
    return " ".join(out_text)


def vqa_normalize(item: str) -> str:
    """Normalize one answer exactly as EvalAI does (vqa_eval_metric.py:
    208-213): tokenize, flatten whitespace, punctuation pass, digit/
    article/contraction pass."""
    item = _word_tokenize(item)
    item = item.replace("\n", " ").replace("\t", " ").strip()
    item = _process_punctuation(item)
    item = _process_digit_article(item)
    return item


def vqa_accuracy_v2(prediction: str, answer_dicts) -> tuple:
    """VQAv2's variant of the leave-one-out accuracy
    (vqav2/utils.py:17-51), which differs from textvqa/ok_vqa/vizwiz in
    three replicated ways:

    - gold answers only get whitespace-flattened up front; the
      punctuation + digit/article passes apply to them (and AGAIN to the
      already-processed prediction) ONLY when the annotators disagree
      (``len(set(answers)) > 1``). A unanimous uppercase gold therefore
      never matches the lowercased prediction — kept bug-for-bug.
    - the leave-one-out excludes by DICT inequality (``item !=
      gtAnsDatum``), so annotator rows that are equal as dicts drop out
      together (real VQAv2 rows differ by answer_id; minimal dicts
      don't) — kept bug-for-bug.
    - the submission payload carries the final (possibly double-passed)
      normalized prediction.

    Takes the doc's ``answers`` list of dicts (each with an "answer"
    key); returns (accuracy, normalized_prediction).
    """
    res = vqa_normalize(prediction)
    if not answer_dicts:
        return 0.0, res
    rows = [{**d, "answer": d["answer"].replace("\n", " ")
             .replace("\t", " ").strip()} for d in answer_dicts]
    if len({d["answer"] for d in rows}) > 1:
        for d in rows:
            d["answer"] = _process_digit_article(
                _process_punctuation(d["answer"]))
        res = _process_digit_article(_process_punctuation(res))
    gt_acc = []
    for gt in rows:
        others = [d for d in rows if d != gt]
        matching = sum(1 for d in others if d["answer"] == res)
        gt_acc.append(min(1.0, matching / 3.0))
    return statistics.mean(gt_acc), res


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """Official VQA leave-one-out accuracy over (typically 10) annotator
    answers: for each annotator, the prediction scores min(1, #matches
    among the OTHER annotators / 3); the sample score is the mean
    (textvqa/utils.py:19-36). All strings are EvalAI-normalized first."""
    if not answers:
        return 0.0
    pred = vqa_normalize(prediction)
    norm = [vqa_normalize(a) for a in answers]
    gt_acc = []
    for i in range(len(norm)):
        others = [norm[j] for j in range(len(norm)) if j != i]
        matching = sum(1 for a in others if a == pred)
        gt_acc.append(min(1.0, matching / 3.0))
    return statistics.mean(gt_acc)
