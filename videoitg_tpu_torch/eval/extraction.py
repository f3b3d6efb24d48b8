"""Answer extraction shared by the MCQ video benchmarks.

Parity: the extract_characters_regex used (with minor letter-set changes)
by videomme/mlvu/cgbench utils in the reference
(lmms_eval/tasks/videomme/utils.py:231-250).
"""

from __future__ import annotations

import re

ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option is" "The correct option is",  # sic — reference concatenation
    "Best answer:" "Best option:",
]


def parse_multi_choice_mmmu(response: str, all_choices, index2ans, seed=0) -> str:
    """MMMU-style multi-choice parsing (reference egoschema/nextqa utils,
    copied from the MMMU eval): look for "(A)", then "A ", then "A.", then
    answer-content substrings; among multiple candidates the one whose
    LAST occurrence starts EARLIEST wins (reference argmin-of-rfind,
    egoschema/utils.py:169 — upstream MMMU differs; keep parity); no match
    falls back to a (deterministically seeded) random choice."""
    import random

    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = " " + response + " "

    index_ans = True
    candidates = []
    for choice in all_choices:
        if f"({choice})" in response:
            candidates.append(f"({choice})")
    for choice in all_choices:
        if f"{choice} " in response:
            candidates.append(f"{choice} ")
    for choice in all_choices:
        if f"{choice}." in response:
            candidates.append(f"{choice}.")
    if not candidates and len(response.split()) > 5:
        for index, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(index)
                index_ans = False
    if not candidates:
        return random.Random(str(seed)).choice(list(all_choices))
    if len(candidates) > 1:
        starts = []
        for can in candidates:
            if index_ans:
                starts.append(response.rfind(can))
            else:
                starts.append(response.lower().rfind(index2ans[can].lower()))
        pred = candidates[min(range(len(candidates)), key=lambda i: starts[i])]
    else:
        pred = candidates[0]
    return pred.replace("(", "").replace(")", "").replace(".", "").strip()


def extract_choice_letter(s: str, letters: str = "ABCD") -> str:
    s = s.strip()
    for prefix in ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search(f"[{letters}]", s):
        return ""
    m = re.search(f"[{letters}]", s)
    return m[0] if m else ""
