"""Response filter pipeline (reference lmms_eval/api/filter.py +
lmms_eval/filters/: selection.py, transformation.py, extraction.py).

Filters transform the raw model responses of a whole task before
process_results sees them: each doc's responses are a LIST (repeats >= 1),
each filter maps list-of-lists -> list-of-lists in order, and an ensemble
chains filters under a name (reference FilterEnsemble, filter.py:33-54).
Tasks opt in with `Task.filters = [(filter_name, kwargs_or_None), ...]`;
the harness wraps each single response into a one-element list, runs the
ensemble, and hands element 0 to process_results — the exact reference flow
for repeats=1 tasks (its evaluator applies ensembles at api/task.py
apply_filters then reads filtered_resps[name]).

The VideoITG-path tasks keep their inline letter extraction
(eval/extraction.py); this generic ensemble exists for ported tasks whose
YAML declares filter_list pipelines (e.g. multi-step regex -> take_first).
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class Filter:
    """Base: apply(resps, docs) maps per-doc response lists, order kept."""

    def apply(self, resps: List[list], docs: List[dict]) -> List[list]:
        return resps


class TakeFirstFilter(Filter):
    def apply(self, resps, docs):
        return [r[:1] for r in resps]


class TakeKFilter(Filter):
    def __init__(self, k: int):
        self.k = int(k)

    def apply(self, resps, docs):
        assert all(len(r) >= self.k for r in resps), (
            f"need >= {self.k} responses per doc (raise repeats)")
        return [r[: self.k] for r in resps]


class MajorityVoteFilter(Filter):
    def apply(self, resps, docs):
        return [[Counter(r).most_common(1)[0][0]] for r in resps]


class WhitespaceFilter(Filter):
    """Strip ONE leading space (reference extraction.py WhitespaceFilter)."""

    def apply(self, resps, docs):
        return [[x[1:] if x.startswith(" ") else x for x in r] for r in resps]


class LowercaseFilter(Filter):
    def apply(self, resps, docs):
        return [[x.lower() for x in r] for r in resps]


class UppercaseFilter(Filter):
    def apply(self, resps, docs):
        return [[x.upper() for x in r] for r in resps]


class MapFilter(Filter):
    def __init__(self, mapping_dict: Optional[dict] = None, default_value=None):
        self.mapping_dict = dict(mapping_dict or {})
        self.default_value = default_value

    def apply(self, resps, docs):
        return [[self.mapping_dict.get(x, self.default_value) for x in r]
                for r in resps]


class RegexFilter(Filter):
    """First regex match (group_select-th), else `fallback`
    (reference extraction.py:33-76)."""

    def __init__(self, regex_pattern: str = r"#### (\-?[0-9\.\,]+)",
                 group_select: int = 0, fallback: str = "[invalid]"):
        self.pattern = re.compile(regex_pattern)
        self.group_select = group_select
        self.fallback = fallback

    def _extract(self, text: str) -> str:
        matches = self.pattern.findall(text)
        if not matches:
            return self.fallback
        m = matches[self.group_select]
        if isinstance(m, tuple):  # multiple groups: first non-empty
            m = next((g for g in m if g), self.fallback)
        return m.strip()

    def apply(self, resps, docs):
        return [[self._extract(x) for x in r] for r in resps]


class MultiChoiceRegexFilter(RegexFilter):
    """Letter extraction for MCQ tasks (reference extraction.py:79-235,
    condensed): regex first; failing that, match a response against the
    doc's choice texts (doc["options"]-style "A. text" lines) and emit the
    letter; failing that, fallback."""

    # The letter must be a standalone token: "The answer is B" must not
    # extract the 'T' of "The" (lookarounds reject letter-adjacent hits).
    def __init__(self,
                 regex_pattern: str = r"(?<![A-Za-z])\(?([A-Z])\)?(?![A-Za-z])",
                 group_select: int = 0, fallback: str = "[invalid]",
                 ignore_case: bool = False, ignore_punctuation: bool = False):
        super().__init__(regex_pattern, group_select, fallback)
        self.ignore_case = ignore_case
        self.ignore_punctuation = ignore_punctuation

    def _norm(self, s: str) -> str:
        if self.ignore_case:
            s = s.lower()
        if self.ignore_punctuation:
            s = re.sub(r"[^\w\s]", "", s)
        return s.strip()

    def apply(self, resps, docs):
        out = []
        for r, doc in zip(resps, docs):
            choices = []
            for line in (doc or {}).get("options", []):
                m = re.match(r"^\(?([A-Z])\)?[.:)]?\s*(.*)$", str(line))
                if m:
                    choices.append((m.group(1), m.group(2)))
            filtered = []
            for x in r:
                got = self._extract(x)
                if got == self.fallback and choices:
                    nx = self._norm(x)
                    got = next((letter for letter, text in choices
                                if text and self._norm(text) in nx),
                               self.fallback)
                filtered.append(got)
            out.append(filtered)
        return out


class GPTMultiChoiceExtractFilter(Filter):
    """mix_evals option extractor (reference mix_evals/video2text/
    utils.py:351-422 GPTMultiChoiceFilter): ask the judge which option
    letter the model's free-text answer corresponds to, reply format
    "[[letter]]", and emit the option INDEX as a string ("0", "1", ...)
    for the exact_match metric against reference_answer. Judge failures
    and unparseable replies fall back to "0" (reference result = 0).
    Routes through eval/judge.py instead of a hard-wired OpenAI client,
    so it runs offline under the exact-match stand-in."""

    _LETTER = re.compile(r"\[\[([A-Z])\]\]")

    def apply(self, resps, docs):
        from videoitg_tpu_torch.eval.judge import get_judge
        from videoitg_tpu_torch.eval.tasks.mix_evals import mc_extract_messages

        judge = get_judge()
        out = []
        for r, doc in zip(resps, docs):
            # The reference formats the WHOLE per-instance resps list into
            # the judge prompt ("Model's Answer: ['foo']",
            # video2text/utils.py:373-375) and emits one result per doc.
            reply = judge(mc_extract_messages(doc, r), max_tokens=999)
            m = self._LETTER.search(reply or "")
            out.append([str(ord(m.group(1)) - ord("A")) if m else "0"])
        return out


FILTER_REGISTRY: Dict[str, Callable[..., Filter]] = {
    "gpt_mc_extract": GPTMultiChoiceExtractFilter,
    "take_first": TakeFirstFilter,
    "take_first_k": TakeKFilter,
    "majority_vote": MajorityVoteFilter,
    "remove_whitespace": WhitespaceFilter,
    "lowercase": LowercaseFilter,
    "uppercase": UppercaseFilter,
    "map": MapFilter,
    "regex": RegexFilter,
    "multi_choice_regex": MultiChoiceRegexFilter,
}


@dataclass
class FilterEnsemble:
    name: str
    filters: List[Filter]

    def apply(self, resps: List[list], docs: List[dict]) -> List[list]:
        for f in self.filters:
            resps = f.apply(resps, docs)
        return resps


def build_filter_ensemble(
    name: str, components: Sequence[Tuple[str, Optional[Dict[str, Any]]]]
) -> FilterEnsemble:
    """[(filter_name, kwargs_or_None), ...] -> FilterEnsemble
    (reference filters/__init__.py:29-43)."""
    filters = []
    for fname, kwargs in components:
        ctor = FILTER_REGISTRY.get(fname)
        if ctor is None:
            raise KeyError(f"unknown filter {fname!r}; have "
                           f"{sorted(FILTER_REGISTRY)}")
        filters.append(ctor(**(kwargs or {})))
    return FilterEnsemble(name=name, filters=filters)


def apply_task_filters(task, responses: List[str],
                       docs: List[dict]) -> List[str]:
    """Run a task's declared filter pipeline over single responses."""
    if not getattr(task, "filters", None):
        return responses
    ensemble = build_filter_ensemble("default", task.filters)
    filtered = ensemble.apply([[r] for r in responses], docs)
    return [r[0] for r in filtered]
