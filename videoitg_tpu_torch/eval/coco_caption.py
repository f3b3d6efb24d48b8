"""Dependency-free coco-caption metrics: BLEU-1..4, ROUGE_L, CIDEr.

The reference's captioning tasks (vatex, youcook2) score through
pycocoevalcap + the Stanford PTB tokenizer jar
(lmms_eval/tasks/vatex/utils.py:120-170, youcook2/utils.py:63-100).
Neither the Java jar nor pycocoevalcap is available offline, so this
module reimplements the three deterministic scorers with the coco-caption
flavors (NOT the sacrebleu flavors — see `metrics.corpus_bleu` for that):

* BLEU: corpus-level clipped n-gram precision with the coco epsilons
  (tiny=1e-15 inside the numerator, small=1e-9 in the denominator),
  "closest" effective reference length, and the exp(1 - 1/ratio) brevity
  penalty applied to every Bleu_n (pycocoevalcap/bleu/bleu_scorer.py).
* ROUGE_L: per-image max-over-refs LCS precision/recall combined with
  beta=1.2, averaged over images (pycocoevalcap/rouge/rouge.py).
* CIDEr: tf-idf weighted n-gram (n=1..4) cosine similarity with the
  gaussian length penalty (sigma=6), df computed over the reference
  corpus, averaged over refs then images, x10
  (pycocoevalcap/cider/cider_scorer.py) — including its quirks: idf is
  log(len(corpus)) - log(max(1, df)) and the "length" entering the
  penalty is the bigram count (so 1-token captions contribute delta
  through a zero length).

Tokenization: the PTB jar is approximated in pure Python — lowercase,
PTB clitic splits (n't, 's, 're, ...), punctuation separated then dropped
(the wrapper's PUNCTUATIONS list). Word-level output matches the jar on
ordinary model captions; exotic Unicode punctuation may tokenize
differently (documented divergence).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

_CLITIC = re.compile(r"(?<=\w)(n't|'s|'re|'ve|'ll|'d|'m)\b", re.IGNORECASE)
# split runs of certain punctuation off words; keep "..." and "--" whole
_PUNCT_SPLIT = re.compile(r"(\.\.\.|--|[.,!?;:()\[\]{}\"`])")


def ptb_tokenize(caption: str) -> List[str]:
    """PTB-style tokens, lowercased, punctuation tokens removed."""
    s = caption.replace("\n", " ").strip()
    s = _CLITIC.sub(r" \1", s)
    s = _PUNCT_SPLIT.sub(r" \1 ", s)
    toks = [t.lower() for t in s.split()]
    # brackets/quotes surface as -LRB-/'' etc. from the jar and are then
    # dropped; splitting them bare and dropping here is equivalent
    dropped = PUNCTUATIONS | {"(", ")", "[", "]", "{", "}", '"'}
    return [t for t in toks if t not in dropped]


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + k])
                   for k in range(1, n + 1)
                   for i in range(len(tokens) - k + 1))


def bleu_scores(gts: Dict, res: Dict, n: int = 4) -> List[float]:
    """Corpus BLEU-1..n, coco flavor (bleu_scorer.py compute_score,
    option "closest"). gts/res map id -> list of token lists (res lists
    have one entry)."""
    tiny, small = 1e-15, 1e-9
    testlen = reflen = 0
    guess = [0] * n
    correct = [0] * n
    for img_id, hyps in res.items():
        hyp = hyps[0]
        refs = gts[img_id]
        testlen += len(hyp)
        # closest ref length; ties broken toward the shorter ref
        reflen += min((len(r) for r in refs),
                      key=lambda rl: (abs(rl - len(hyp)), rl))
        max_ref = Counter()
        for r in refs:
            for ng, c in _ngram_counts(r, n).items():
                max_ref[ng] = max(max_ref[ng], c)
        hyp_counts = _ngram_counts(hyp, n)
        for k in range(n):
            guess[k] += max(0, len(hyp) - k)
        for ng, c in hyp_counts.items():
            correct[len(ng) - 1] += min(c, max_ref[ng])
    bleus = []
    prod = 1.0
    for k in range(n):
        prod *= (correct[k] + tiny) / (guess[k] + small)
        bleus.append(prod ** (1.0 / (k + 1)))
    ratio = (testlen + tiny) / (reflen + small)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(gts: Dict, res: Dict, beta: float = 1.2) -> float:
    """Mean over images of max-over-refs LCS-F(beta) (rouge.py)."""
    scores = []
    for img_id, hyps in res.items():
        hyp = hyps[0]
        precs, recs = [], []
        for ref in gts[img_id]:
            lcs = _lcs_len(ref, hyp)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(ref) if ref else 0.0)
        p, r = max(precs), max(recs)
        scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p)
                      if p and r else 0.0)
    return sum(scores) / len(scores) if scores else 0.0


def cider(gts: Dict, res: Dict, n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr (cider_scorer.py): tf-idf n-gram cosine, gaussian length
    penalty, avg over refs then images, x10."""
    doc_freq: Dict = defaultdict(int)
    for refs in gts.values():
        seen = set()
        for ref in refs:
            seen.update(_ngram_counts(ref, n).keys())
        for ng in seen:
            doc_freq[ng] += 1
    ref_len = math.log(float(len(gts))) if gts else 0.0

    def counts2vec(tokens):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in _ngram_counts(tokens, n).items():
            df = math.log(max(1.0, doc_freq[ng]))
            k = len(ng) - 1
            vec[k][ng] = tf * (ref_len - df)
            norm[k] += vec[k][ng] ** 2
            if k == 1:  # reference quirk: "length" is the bigram count
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = 0.0
        for k in range(n):
            s = sum(min(vh[k][ng], vr[k][ng]) * vr[k][ng]
                    for ng in vh[k])
            if nh[k] and nr[k]:
                s /= nh[k] * nr[k]
            val += s * math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for img_id, hyps in res.items():
        vh, nh, lh = counts2vec(hyps[0])
        score = 0.0
        refs = gts[img_id]
        for ref in refs:
            vr, nr, lr = counts2vec(ref)
            score += sim(vh, vr, nh, nr, lh, lr)
        scores.append(score / (n * len(refs)) * 10.0)
    return sum(scores) / len(scores) if scores else 0.0


COCO_METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr")


def compute_coco_metrics(records: Sequence[dict],
                         prefix: str = "") -> Dict[str, float]:
    """records: [{"video_id", "pred": str, "answer": [str, ...]}].
    Returns the coco metric dict (METEOR/SPICE omitted: both need
    external binaries in the reference too)."""
    gts, res = {}, {}
    for i, r in enumerate(records):
        # coco indexes by image id; distinct docs can share a video
        key = (r.get("video_id", ""), i)
        answers = r["answer"] if isinstance(r["answer"], (list, tuple)) \
            else [r["answer"]]
        gts[key] = [ptb_tokenize(a) for a in answers]
        res[key] = [ptb_tokenize(r["pred"])]
    if not res:
        return {f"{prefix}{m}": 0.0 for m in COCO_METRICS}
    bleus = bleu_scores(gts, res)
    out = {f"{prefix}Bleu_{k + 1}": bleus[k] for k in range(4)}
    out[f"{prefix}ROUGE_L"] = rouge_l(gts, res)
    out[f"{prefix}CIDEr"] = cider(gts, res)
    return out
