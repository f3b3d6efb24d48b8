"""Type casts, geometry helpers, and LaTeX normalization (parity:
lmms_eval/tasks/megabench/metrics/scoring/common/conversions.py,
common/metrics.py, common/transformations.py)."""

from __future__ import annotations

import ast
import json
import math
import re
import unicodedata
from numbers import Number
from typing import Iterable

from videoitg_tpu_torch.eval.megabench.parsing import parse_json


def freeze_structure(obj):
    """conversions.py:12-21."""
    if isinstance(obj, dict):
        return frozenset((k, freeze_structure(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return tuple(freeze_structure(item) for item in obj)
    if isinstance(obj, set):
        return frozenset(obj)
    return obj


def cast_to_set(obj) -> set:
    """conversions.py:24-29."""
    obj = freeze_structure(obj)
    if isinstance(obj, (frozenset, set, tuple)):
        return set(obj)
    return str_to_set(obj)


def cast_to_dict(obj):
    """conversions.py:32-41."""
    if isinstance(obj, dict):
        return {key: cast_to_dict(val) for key, val in obj.items()}
    if isinstance(obj, str):
        attempt = parse_json(obj)
        if attempt:
            return attempt
        return obj
    return obj


def str_to_iterable(func, iterable_str):
    """conversions.py:44-79."""
    if not isinstance(iterable_str, str):
        return func()
    iterable_str = iterable_str.strip(" ")
    if not iterable_str:
        return func()
    is_in_iterable = True
    if iterable_str[0] == "(":
        if not iterable_str.endswith(")"):
            return func()
    elif iterable_str[0] == "{":
        if not iterable_str.endswith("}"):
            return func()
    elif iterable_str[0] == "[":
        if not iterable_str.endswith("]"):
            return func()
    else:
        is_in_iterable = False
    try:
        eval_ = ast.literal_eval(iterable_str)
        if eval_ is None:
            return ""
        if isinstance(eval_, (int, float)):
            eval_ = [eval_]
        return func(eval_)
    except (SyntaxError, ValueError):
        if is_in_iterable:
            iterable_str = iterable_str[1:-1]
        items = [item.strip() for item in iterable_str.split(",")]
        return func(items)
    except TypeError:
        return func()


def str_to_set(iterable_str) -> set:
    return str_to_iterable(set, iterable_str)


def str_to_list(iterable_str) -> list:
    return str_to_iterable(list, iterable_str)


def str_to_bboxes(bbox_list) -> list:
    """conversions.py:92-115."""
    if not isinstance(bbox_list, str):
        return []
    try:
        bboxes = ast.literal_eval(bbox_list)
    except (SyntaxError, ValueError):
        try:
            bboxes = json.loads(bbox_list)
        except json.JSONDecodeError:
            return []
    if len(bboxes) == 4 and isinstance(bboxes[0], Number):
        bboxes = [bboxes]
    if not isinstance(bboxes, (tuple, list)):
        return []
    new_bboxes = []
    for bbox in bboxes:
        if not isinstance(bbox, (tuple, list)) or len(bbox) != 4:
            continue
        if any(not isinstance(coord, (float, int)) for coord in bbox):
            continue
        new_bboxes.append(bbox)
    return new_bboxes


def str_to_coords(coord_list, dim=2) -> list:
    """conversions.py:118-135."""
    if not isinstance(coord_list, str):
        return []
    try:
        coords = ast.literal_eval(coord_list)
    except SyntaxError:
        try:
            coords = json.loads(coord_list)
        except json.JSONDecodeError:
            return []
    new_coords = []
    for coord in coords:
        if not isinstance(coord, (tuple, list)) or len(coord) != dim:
            continue
        if any(not isinstance(c, (float, int)) for c in coord):
            continue
        new_coords.append(coord)
    return new_coords


def parse_point_2d_from_xml(xml_string):
    """conversions.py:138-155."""
    if not isinstance(xml_string, str):
        return None
    matches = re.findall(r"<point>(.*?)<\/point>", xml_string)
    if len(matches) >= 2:
        return None
    if matches:
        coords = matches[0].split(",")
        if len(coords) != 2:
            return None
        try:
            return tuple(float(coord.strip()) for coord in coords)
        except ValueError:
            return None
    return None


def parse_bboxes_from_xml(xml_string) -> list:
    """conversions.py:158-177."""
    if not isinstance(xml_string, str):
        return []
    matches = re.findall(r"<box>(.*?)<\/box>", xml_string)
    new_bboxes = []
    for match in matches:
        coords = match.split(",")
        if len(coords) != 4:
            continue
        try:
            bbox = tuple(float(coord.strip()) for coord in coords)
        except ValueError:
            continue
        new_bboxes.append(bbox)
    return new_bboxes


# --- common/metrics.py --------------------------------------------------------

def calculate_iou(predicted, target):
    """metrics.py:6-39 — best-target IoU per predicted box."""
    def box_area(box):
        return (box[2] - box[0]) * (box[3] - box[1])

    def box_iou(box1, box2):
        x1, y1 = max(box1[0], box2[0]), max(box1[1], box2[1])
        x2, y2 = min(box1[2], box2[2]), min(box1[3], box2[3])
        intersection = max(0, x2 - x1) * max(0, y2 - y1)
        union = box_area(box1) + box_area(box2) - intersection
        return intersection / union if union > 0 else 0

    iou_scores = []
    for pred_box in predicted:
        best = 0
        for target_box in target:
            best = max(best, box_iou(pred_box, target_box))
        iou_scores.append(best)
    return iou_scores


def jaccard_index(predicted: Iterable, target: Iterable) -> float:
    """metrics.py:42-66."""
    pred, tget = set(predicted), set(target)
    denom = len(pred | tget)
    return 1 if not denom else len(pred & tget) / denom


def set_precision(predicted: Iterable, target: Iterable) -> float:
    pred, tget = set(predicted), set(target)
    denom = len(pred)
    return 1 if not denom else len(pred & tget) / denom


def longest_common_prefix(list1: list, list2: list) -> list:
    """metrics.py:81-88."""
    index = next((i for i, (a, b) in enumerate(zip(list1, list2))
                  if a != b), min(len(list1), len(list2)))
    return list1[:index]


def mse(predicted, target):
    return (predicted - target) ** 2


def point_distance(predicted, target):
    """metrics.py:96-101."""
    if len(predicted) != len(target):
        raise ValueError("point_distance: dimension mismatch.")
    return math.sqrt(sum((a - b) ** 2 for a, b in zip(predicted, target)))


# --- common/transformations.py -------------------------------------------------

GREEK_TO_LATEX = {
    "α": "\\alpha", "β": "\\beta", "γ": "\\gamma", "δ": "\\delta",
    "ε": "\\epsilon", "ζ": "\\zeta", "η": "\\eta", "θ": "\\theta",
    "ι": "\\iota", "κ": "\\kappa", "λ": "\\lambda", "μ": "\\mu",
    "ν": "\\nu", "ξ": "\\xi", "ο": "\\omicron", "π": "\\pi",
    "ρ": "\\rho", "σ": "\\sigma", "τ": "\\tau", "υ": "\\upsilon",
    "φ": "\\phi", "χ": "\\chi", "ψ": "\\psi", "ω": "\\omega",
    "Α": "\\Alpha", "Β": "\\Beta", "Γ": "\\Gamma", "Δ": "\\Delta",
    "Ε": "\\Epsilon", "Ζ": "\\Zeta", "Η": "\\Eta", "Θ": "\\Theta",
    "Ι": "\\Iota", "Κ": "\\Kappa", "Λ": "\\Lambda", "Μ": "\\Mu",
    "Ν": "\\Nu", "Ξ": "\\Xi", "Ο": "\\Omicron", "Π": "\\Pi",
    "Ρ": "\\Rho", "Σ": "\\Sigma", "Τ": "\\Tau", "Υ": "\\Upsilon",
    "Φ": "\\Phi", "Χ": "\\Chi", "Ψ": "\\Psi", "Ω": "\\Omega",
}


def remove_def_indef_articles(text: str) -> str:
    """transformations.py:7-10."""
    return " ".join(t for t in text.split(" ")
                    if t.lower() not in {"the", "a"})


def replace_macrons_with_latex_overline(text: str) -> str:
    """transformations.py:13-28."""
    result = []
    for char in text:
        if char.isalpha():
            decomposed = unicodedata.normalize("NFD", char)
            if len(decomposed) > 1 and decomposed[1] == "\u0304":
                result.append(f"\\overline{{{decomposed[0]}}}")
            else:
                result.append(char)
        elif char != "\u0304":
            result.append(char)
        else:
            result[-1] = f"\\overline{{{result[-1]}}}"
    return "".join(result)


def fix_overline_underscores(text: str) -> str:
    """transformations.py:31-34."""
    pattern = r"\\overline\{([^}]*)\}_([^{}\\ ]*)"
    return re.sub(pattern, r"\\overline{\1_\2}", text)


def replace_greek_letters(text: str) -> str:
    """transformations.py:95-97."""
    return re.sub(r"[α-ωΑ-Ω]",
                  lambda m: GREEK_TO_LATEX[m.group()] + " ", text)


def remove_latex_math_delimiters(latex_str: str) -> str:
    """transformations.py:100-112."""
    latex_str = re.sub(r"\\(begin|end)\{.*?\}(?:\[[^\[\]]*\])?", "",
                      latex_str)
    latex_str = re.sub(r"\\\(|\\\)", "", latex_str)
    latex_str = re.sub(r"\\\[|\\\]", "", latex_str)
    return latex_str


def normalize_latex(text: str) -> str:
    """transformations.py:115-122."""
    text = text.replace("\\bar", "\\overline")
    text = replace_macrons_with_latex_overline(text)
    text = fix_overline_underscores(text)
    text = replace_greek_letters(text)
    text = remove_latex_math_delimiters(text)
    return text


def strip_accents(text: str) -> str:
    """Stand-in for unidecode.unidecode (not in this image): NFKD
    decomposition with combining marks dropped — covers the accent
    folding NearStrMatch relies on; full transliteration (e.g. CJK)
    diverges and is documented at the call site."""
    return "".join(c for c in unicodedata.normalize("NFKD", text)
                   if not unicodedata.combining(c))
