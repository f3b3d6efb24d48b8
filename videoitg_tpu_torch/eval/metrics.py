"""Metric utilities: bootstrap standard errors.

Parity: the reference attaches bootstrap stderr to aggregated metrics
(lmms_eval/api/metrics.py:324+). Deterministic seeding keeps reruns stable.
"""

from __future__ import annotations

import math
import random
from typing import Callable, List, Sequence


def bootstrap_stderr(
    records: Sequence,
    statistic: Callable[[List], float],
    iters: int = 1000,
    seed: int = 1234,
) -> float:
    """Stderr of `statistic` over bootstrap resamples of `records`."""
    n = len(records)
    if n <= 1:
        return 0.0
    rng = random.Random(seed)
    stats = []
    for _ in range(iters):
        sample = [records[rng.randrange(n)] for _ in range(n)]
        stats.append(statistic(sample))
    mean = sum(stats) / len(stats)
    var = sum((s - mean) ** 2 for s in stats) / (len(stats) - 1)
    return var ** 0.5


# ---------------------------------------------------------------------------
# Standard metric / aggregation library (reference lmms_eval/api/metrics.py).
# Pure-python (no sklearn/sacrebleu in the TPU image); each function keeps
# the reference's semantics at the call sites our tasks (and ported tasks)
# use. Higher is better unless noted.
# ---------------------------------------------------------------------------


def mean(items: Sequence[float]) -> float:
    return sum(items) / len(items) if items else 0.0


def median(items: Sequence[float]) -> float:
    s = sorted(items)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def perplexity(logprobs: Sequence[float]) -> float:
    """exp(-mean loglikelihood) (reference metrics.py:30-37)."""
    return math.exp(-mean(list(logprobs)))


def weighted_perplexity(items: Sequence) -> float:
    """items: (loglikelihood, num_tokens) pairs (reference metrics.py:40-42)."""
    total_ll = sum(ll for ll, _ in items)
    total_n = sum(n for _, n in items)
    return math.exp(-total_ll / max(1, total_n))


def bits_per_byte(items: Sequence) -> float:
    total_ll = sum(ll for ll, _ in items)
    total_n = sum(n for _, n in items)
    return -total_ll / max(1, total_n) / math.log(2)


def levenshtein_distance(s1: str, s2: str) -> int:
    """Edit distance (reference metrics.py:278-291, same DP)."""
    if len(s1) > len(s2):
        s1, s2 = s2, s1
    distances = list(range(len(s1) + 1))
    for i2, c2 in enumerate(s2):
        new = [i2 + 1]
        for i1, c1 in enumerate(s1):
            if c1 == c2:
                new.append(distances[i1])
            else:
                new.append(1 + min(distances[i1], distances[i1 + 1], new[-1]))
        distances = new
    return distances[-1]


def anls(references: Sequence[str], prediction: str,
         threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity for one question
    (reference metrics.py:294-321: best-matching reference, scores below
    the threshold floor to 0)."""
    values = []
    det = " ".join(prediction.strip().lower().split())
    for answer in references:
        gt = " ".join(answer.strip().lower().split())
        dist = levenshtein_distance(gt, det)
        length = max(len(answer.upper()), len(prediction.upper()))
        values.append(0.0 if length == 0 else float(dist) / float(length))
    result = 1 - min(values) if values else 0.0
    return 0.0 if result < threshold else result


def exact_match(prediction: str, references: Sequence[str],
                ignore_case: bool = True,
                ignore_punctuation: bool = False) -> float:
    """1.0 if the prediction string equals any reference (the reference
    routes through HF evaluate's exact_match, metrics.py:190-231; these are
    the two knobs our tasks use)."""
    import string

    def norm(s: str) -> str:
        if ignore_case:
            s = s.lower()
        if ignore_punctuation:
            s = s.translate(str.maketrans("", "", string.punctuation))
        return s.strip()

    p = norm(prediction)
    return 1.0 if any(p == norm(r) for r in references) else 0.0


def f1_binary(golds: Sequence[int], preds: Sequence[int]) -> float:
    """Binary F1 over 0/1 labels (reference metrics.py:51-60 via sklearn)."""
    tp = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 1)
    fp = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 1)
    fn = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 0)
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def matthews_corrcoef(golds: Sequence[int], preds: Sequence[int]) -> float:
    """MCC over 0/1 labels (reference metrics.py:63-70 via sklearn)."""
    tp = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 1)
    tn = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 0)
    fp = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 1)
    fn = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 0)
    denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
    return (tp * tn - fp * fn) / denom if denom else 0.0


def _ngrams(tokens: Sequence[str], n: int):
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


def _tokenize_13a(line: str) -> list:
    """mteval-v13a tokenization (sacrebleu's default `13a` tokenizer):
    normalize a few SGML entities, then split punctuation — periods/commas
    stay attached between digits."""
    import re

    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                .replace("&lt;", "<").replace("&gt;", ">"))
    line = f" {line} "
    line = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", line)
    line = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", line)
    line = re.sub(r"([\.,])([^0-9])", r" \1 \2", line)
    line = re.sub(r"([0-9])(-)", r"\1 \2 ", line)
    return line.split()


def corpus_bleu(predictions: Sequence[str],
                references: Sequence[Sequence[str]],
                max_n: int = 4) -> float:
    """Corpus BLEU-4, sacrebleu-compatible: 13a tokenization, clipped
    n-gram precisions with `exp` smoothing (Chen & Cherry), closest-
    reference-length brevity penalty, 0-100 scale. Dependency-free
    reimplementation of sacrebleu.corpus_bleu's defaults (the reference
    routes through sacrebleu, lmms_eval/api/metrics.py:74-88); exact-parity
    fuzz-tested against sacrebleu in tests/test_metrics.py."""
    from collections import Counter

    match = [0] * max_n
    total = [0] * max_n
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(predictions, references):
        p_tok = _tokenize_13a(pred)
        r_toks = [_tokenize_13a(r) for r in refs]
        pred_len += len(p_tok)
        # closest reference length, shorter wins ties (sacrebleu convention)
        ref_len += min((abs(len(r) - len(p_tok)), len(r)) for r in r_toks)[1]
        for n in range(1, max_n + 1):
            p_counts = Counter(_ngrams(p_tok, n))
            max_ref = Counter()
            for r in r_toks:
                for gram, c in Counter(_ngrams(r, n)).items():
                    max_ref[gram] = max(max_ref[gram], c)
            match[n - 1] += sum(min(c, max_ref[g]) for g, c in p_counts.items())
            total[n - 1] += max(0, len(p_tok) - n + 1)

    if not any(match):
        return 0.0  # no n-gram matches at ANY order (sacrebleu early-out)

    # Percent-scale precisions; zero-match orders get the mteval `exp`
    # smoothing (1 / 2^k of a count), zero-total orders stay 0.
    precisions = [0.0] * max_n
    smooth = 1.0
    for i in range(max_n):
        if total[i] == 0:
            continue
        if match[i] == 0:
            smooth *= 2.0
            precisions[i] = 100.0 / (smooth * total[i])
        else:
            precisions[i] = 100.0 * match[i] / total[i]
    if any(p == 0.0 for p in precisions):
        return 0.0
    log_prec = sum(math.log(p) for p in precisions) / max_n
    bp = 1.0 if pred_len > ref_len else (
        math.exp(1 - ref_len / pred_len) if pred_len > 0 else 0.0)
    return bp * math.exp(log_prec)
