"""MEGA-Bench metric registry (parity: lmms_eval/tasks/megabench/
metrics/metric_type.py + metrics/scoring/*.py — all 45 metric names
resolve; the dependency/network-bound ones degrade as documented).

Portable-and-exact (pure python or in-image deps): the exact/simple/
case-insensitive string matches, Damerau-Levenshtein similarity
(rapidfuzz), number_rel_diff_ratio, every set/dict/sequence/jaccard
variant, positive_int_match, chess-move jaccard, list-prefix ratio,
sacrebleu BLEU, jieba+nltk Chinese GLEU, all bbox/point IoU-and-distance
metrics (plain + XML-tagged), normalized/angle RMSE, keypoint
coordinate similarity, multi-reference phrase, boxed/general numerical
match, the PDDL plan checker (planning.py), and program_judge (stdin/
stdout python code testing in a subprocess).

Judge-backed: gpt_4o_as_judge and ascii_art_gpt4o_judge route through
videoitg_tpu_torch.eval.judge.get_judge() with the reference's prompt
construction (template_mapping over answers/eval_context, images
attached; ascii art rendered to 224x224 via PIL exactly as
conversions.py:ascii_text_to_image).

Documented degradations (each returns the reference's "unsupported"
sentinel -1, which MeanAggregation excludes, when its dependency is
absent): near_str_match folds accents with NFKD instead of unidecode;
nli_entailment needs the deberta-large-mnli checkpoint (path via
VIDEOITG_NLI_MODEL, else -1); geo_proximity needs live Nominatim
geocoding (no egress here, -1); constrained_generation needs the CMU
pronouncing dictionary (absent, -1).
"""

from __future__ import annotations

import ast
import math
import re
from numbers import Number

from videoitg_tpu_torch.eval.megabench import conversions as C
from videoitg_tpu_torch.eval.megabench import parsing as P
from videoitg_tpu_torch.eval.megabench.planning import SymbolicPlanningMetricTest


# --- string matches -----------------------------------------------------------

def parse_single_letter(s):
    """exact_str_match.py:6-15."""
    match = re.match(r"^\(?([A-Za-z])\)?(?:\s*\.\s*|\.)?(.*)", s)
    return match.group(1) if match else s


class ExactStrMatch:
    @staticmethod
    def match(response, correct_answer) -> int:
        """exact_str_match.py:18-33."""
        if not isinstance(response, str):
            response = str(response)
        if not isinstance(correct_answer, str):
            correct_answer = str(correct_answer)
        if len(correct_answer) == 1 and correct_answer.isalpha() \
                and len(response) > 1:
            response = parse_single_letter(response)
        return 1 if response == correct_answer else 0


class CodeResultExactStrMatch:
    @staticmethod
    def match(response, correct_answer) -> int:
        """exact_str_match.py:36-48."""
        correct_answer, _ = P.extract_code_block_content(
            correct_answer, is_ascii_art=True,
            should_remove_surrounding_whitespace=False)
        return ExactStrMatch.match(response, correct_answer)


class SimpleStrMatch:
    @staticmethod
    def match(response, correct_answer) -> int:
        """simple_str_match.py:4-14."""
        if not isinstance(response, str):
            response = str(response)

        def canon(s):
            return (s.replace(" ", "").replace("-", "").replace("\n", "")
                    .replace("\t", "").replace(".", "").lower())

        return ExactStrMatch.match(canon(response), canon(correct_answer))


class ExactStrMatchCaseInsensitive:
    @staticmethod
    def match(response, correct_answer) -> int:
        """exact_str_match_case_insensitive.py."""
        if not isinstance(response, str) and isinstance(correct_answer,
                                                        str):
            return 0
        return ExactStrMatch.match(response.lower(),
                                   correct_answer.lower())


class NormalizedSimilarityDamerauLevenshtein:
    @staticmethod
    def match(response, correct_answer):
        """normalized_similarity_damerau_levenshtein.py."""
        import rapidfuzz

        if not isinstance(response, str) and isinstance(correct_answer,
                                                        str):
            return 0
        return rapidfuzz.distance.DamerauLevenshtein \
            .normalized_similarity(response, correct_answer)


class NearStrMatch:
    @staticmethod
    def match(response, correct_answer, threshold=0.9):
        """near_str_match.py (NFKD accent folding stands in for
        unidecode — module docstring)."""
        import rapidfuzz

        if not isinstance(response, str) \
                or not isinstance(correct_answer, str):
            return 0

        def approximate(text):
            return C.strip_accents(
                C.remove_def_indef_articles(text)).lower()

        return rapidfuzz.distance.DamerauLevenshtein \
            .normalized_similarity(approximate(response),
                                   approximate(correct_answer),
                                   score_cutoff=threshold)


class NumberRelDiffRatio:
    @staticmethod
    def match(response, correct_answer):
        """number_rel_diff_ratio.py."""
        try:
            if isinstance(response, Number):
                pred = response
            else:
                pred = ast.literal_eval(response)
            if not isinstance(pred, Number):
                return 0
            gt = ast.literal_eval(correct_answer)
            return max(0, 1 - math.fabs((pred - gt) / gt))
        except (SyntaxError, ValueError):
            return 0


class PositiveIntMatch:
    @staticmethod
    def match(response, correct_answer) -> int:
        """positive_int_match.py."""
        try:
            response_obj = ast.literal_eval(response)
        except (SyntaxError, ValueError):
            return 0
        if not correct_answer:
            return 0
        correct_answer_obj = ast.literal_eval(correct_answer)
        assert isinstance(correct_answer_obj, int)
        if not isinstance(response_obj, int):
            return 0
        if correct_answer_obj <= 0 and response_obj <= 0:
            return -1
        return 1 if response_obj == correct_answer_obj else 0


# --- set / dict / sequence family ----------------------------------------------

class SetEquality:
    @classmethod
    def match(cls, responses, targets) -> int:
        return 1 if C.cast_to_set(responses) == C.cast_to_set(targets) \
            else 0


class SetEqualityCaseInsensitive:
    @classmethod
    def match(cls, responses, targets) -> int:
        try:
            r = {t.upper() for t in C.cast_to_set(responses)}
            t = {t.upper() for t in C.cast_to_set(targets)}
        except AttributeError:
            return 0
        return 1 if r == t else 0


class StringSetEqualityLineSplit:
    @classmethod
    def match(cls, responses, targets) -> int:
        """set_equality.py:30-44."""
        if "\\n" in targets:
            targets = targets.replace("\\n", "\n")
        if "\\n" in responses:
            responses = responses.replace("\\n", "\n")
        r = {i.lower() if isinstance(i, str) else i
             for i in set(responses.split("\n"))}
        t = {i.lower() if isinstance(i, str) else i
             for i in set(targets.split("\n"))}
        return 1 if r == t else 0


class StringSetEqualityCommaSplit:
    @classmethod
    def match(cls, responses, targets) -> int:
        """set_equality.py:47-62."""
        r = {i.lower() if isinstance(i, str) else i
             for i in C.str_to_set(responses)}
        t = {i.lower() if isinstance(i, str) else i
             for i in C.str_to_set(targets)}
        return 1 if r == t else 0


class Jaccard:
    @classmethod
    def match(cls, responses, targets):
        if responses is None:
            return 0
        return C.jaccard_index(C.cast_to_set(responses),
                               C.cast_to_set(targets))


class JaccardCaseInsensitive:
    @classmethod
    def match(cls, responses, targets):
        """jaccard.py:20-50."""
        if responses is None:
            return 0
        responses = C.cast_to_set(responses)
        targets = C.cast_to_set(targets)
        first = list(targets)[0] if targets else ""
        if isinstance(first, str):
            new_r = {i.lower() if isinstance(i, str) else str(i).lower()
                     for i in responses}
            new_t = {i.lower() for i in targets}
        elif isinstance(first, tuple):
            def canon(item):
                return tuple(x.lower().replace(" ", "").replace("-", "")
                             .replace("\n", "").replace("\t", "")
                             .replace("_", "").replace(".", "")
                             for x in item)
            try:
                new_r = {canon(res) for res in responses}
            except Exception:
                return 0
            new_t = {canon(tgt) for tgt in targets}
        else:
            return 0
        return C.jaccard_index(new_r, new_t)


class SetPrecision:
    @classmethod
    def match(cls, responses, targets):
        if responses is None:
            return 0
        return C.set_precision(C.cast_to_set(responses),
                               C.cast_to_set(targets))


class ChessMoveJaccard:
    @classmethod
    def match(cls, responses, targets):
        """chess_jaccard.py."""
        if responses is None:
            return 0

        def transform(seq):
            return {m.removesuffix("!").removesuffix("#")
                    for m in C.str_to_set(seq)}

        return C.jaccard_index(transform(responses), transform(targets))


class DictEquality:
    @classmethod
    def match(cls, responses, targets):
        responses = C.cast_to_dict(responses)
        targets = C.cast_to_dict(targets)
        if not isinstance(responses, dict):
            return 0
        return 1 if responses == targets else 0


class DictPrecision:
    @classmethod
    def match(cls, responses, targets):
        """dict_equality.py:26-45."""
        responses = C.cast_to_dict(responses)
        targets = C.cast_to_dict(targets)
        if not isinstance(responses, dict) or len(responses) == 0:
            return 0
        matched = sum(1 for k, v in responses.items()
                      if k in targets and ExactStrMatch.match(v, targets[k]))
        return matched / len(responses)


class DictExactStrMatchAggRecall:
    @classmethod
    def match(cls, responses, targets):
        """dict_exact_match_agg_recall.py."""
        responses = C.cast_to_dict(responses)
        targets = C.cast_to_dict(targets)
        if not isinstance(responses, dict):
            return 0
        total = sum(ExactStrMatch.match(responses.get(k), v)
                    for k, v in targets.items())
        return total / len(targets) if targets else 0


def _dict_agg(metric_cls, responses, targets):
    """Shared shape of the dict_*_agg_jaccard scorers."""
    responses = C.cast_to_dict(responses)
    targets = C.cast_to_dict(targets)
    if not isinstance(responses, dict):
        return 0
    all_keys = set(responses) | set(targets)
    if not all_keys:
        return 0
    return sum(metric_cls.match(responses.get(k, []),
                                targets.get(k, []))
               for k in all_keys) / len(all_keys)


class DictJaccardAggJaccard:
    @classmethod
    def match(cls, responses, targets):
        return _dict_agg(Jaccard, responses, targets)


class DictSetEqualityAggJaccard:
    @classmethod
    def match(cls, responses, targets):
        return _dict_agg(SetEquality, responses, targets)


class DictNbboxIouTupleAggJaccard:
    @classmethod
    def match(cls, responses, targets):
        return _dict_agg(NbboxIouTuple, responses, targets)


class SequenceEquality:
    @classmethod
    def match(cls, responses, targets) -> int:
        if not isinstance(responses, str):
            responses = str(responses)
        return 1 if C.str_to_list(responses) == C.str_to_list(targets) \
            else 0


class SequenceEqualityCaseInsensitive:
    @classmethod
    def match(cls, responses, targets) -> int:
        if not isinstance(responses, str):
            responses = str(responses)
        r = [i.lower() if isinstance(i, str) else str(i)
             for i in C.str_to_list(responses)]
        t = [i.lower() for i in C.str_to_list(targets)]
        return 1 if r == t else 0


class SequenceAccuracyCaseInsensitive:
    @classmethod
    def match(cls, responses, targets):
        """sequence_equality.py:39-62."""
        responses = C.str_to_list(responses)
        targets = C.str_to_list(targets)
        if len(targets) != len(responses):
            return 0
        correct = 0
        for res, tgt in zip(responses, targets):
            if isinstance(tgt, str):
                if res.lower() == tgt.lower():
                    correct += 1
            elif isinstance(tgt, Number) and isinstance(res, Number):
                if res == tgt:
                    correct += 1
        return correct / len(targets)


class LongestCommonListPrefixRatio:
    @classmethod
    def match(cls, responses, targets):
        responses = C.str_to_list(responses)
        targets = C.str_to_list(targets)
        return len(C.longest_common_prefix(responses, targets)) \
            / len(targets)


class MultipleReferencePhraseEval:
    @staticmethod
    def match(response, targets):
        """multi_ref_phrase.py."""
        targets = targets.replace("，", ",")
        refs = C.str_to_iterable(list, targets)
        for ref in refs:
            str_ref = ref if isinstance(ref, str) else str(ref)
            if SimpleStrMatch.match(response, str_ref):
                return 1
        return 0


# --- text-generation metrics ----------------------------------------------------

class Bleu:
    @staticmethod
    def match(response, correct_answer):
        """sacrebleu_bleu.py."""
        import sacrebleu

        if isinstance(response, str) and isinstance(correct_answer, str):
            resp, corr = [response], [correct_answer]
        elif isinstance(response, (list, tuple)) \
                and isinstance(correct_answer, (list, tuple)):
            resp, corr = tuple(response), tuple(correct_answer)
        else:
            return 0
        return sacrebleu.corpus_bleu(corr, [resp]).score / 100


class GLEUChinese:
    @staticmethod
    def match(response, correct_answer):
        """gleu.py — jieba search-mode tokens into NLTK sentence GLEU."""
        import jieba
        from nltk.translate.gleu_score import sentence_gleu

        if isinstance(response, str) and isinstance(correct_answer, str):
            reference_tokens = list(jieba.cut_for_search(response))
            translation_tokens = list(jieba.cut_for_search(correct_answer))
        else:
            return 0
        return sentence_gleu([reference_tokens], translation_tokens)


# --- LaTeX --------------------------------------------------------------------

class LatexExprEquality:
    @classmethod
    def match(cls, responses, targets) -> int:
        """latex_expr_equality.py:21-46 (the in-tree latex parser stands
        in for antlr parse_latex; parse failures fall back to
        SimpleStrMatch exactly as upstream)."""
        from videoitg_tpu_torch.eval.tasks.olympiadbench import _parse_latex

        if not isinstance(responses, str) or not isinstance(targets, str):
            return 0
        try:
            r = C.normalize_latex(responses)
            t = C.normalize_latex(targets)
            r_expr = _parse_latex(r)
            t_expr = _parse_latex(t)
            return 1 if r_expr.equals(t_expr) else 0
        except Exception:
            return SimpleStrMatch.match(responses, targets)


class TextLatexExprEquality:
    @classmethod
    def match(cls, responses, targets) -> int:
        """latex_expr_equality.py:49-101."""
        if not isinstance(responses, str) or not isinstance(targets, str):
            return 0

        def separate(text):
            parts = re.split(r"(\$[^$]*\$)", text)
            latex, plain = [], []
            for part in parts:
                if part.startswith("$") and part.endswith("$"):
                    latex.append(part)
                else:
                    plain.append(part.strip())
            return plain, latex

        def join_latex(exps):
            return " ".join(e[1:-1].strip().replace(",", "")
                            for e in exps)

        tgt_texts, tgt_latex = separate(targets)
        res_texts, res_latex = separate(responses)
        text_match = SimpleStrMatch.match(
            "".join(res_texts).replace(",", ""),
            "".join(tgt_texts).replace(",", ""))
        latex_match = LatexExprEquality.match(join_latex(res_latex),
                                              join_latex(tgt_latex))
        return 1 if text_match and latex_match else 0


# --- numerical ----------------------------------------------------------------

def _clean_units(pred_str: str) -> str:
    """general_numerical_match.py:89-109 (MAmmoTH number_utils)."""
    s = pred_str.replace("\\pi", "π")
    s = re.sub(r"(?<![\d}])\\?π", "3.14", s)
    s = re.sub(r"(\d)(\\?π)", r"\1*3.14", s)
    s = re.sub(r"\{(\\?π)\}", "3.14", s)
    s = re.sub(r"\*(\\?π)", "*3.14", s)
    s = s.replace("%", "/100").replace("$", "").replace("¥", "")
    s = s.replace("°C", "").replace(" C", "").replace("°", "")
    return s


def _floatify(num):
    try:
        num = float(num)
        return round(num) if num.is_integer() else num
    except Exception:
        return None


_SAFE_EVAL_RE = re.compile(r"^[\d\s\.\+\-\*\/\(\)eE,]*$")


def _number_it(num):
    """general_numerical_match.py:112-133. The reference eval()s
    arbitrary leftover strings in a killable subprocess; here eval is
    restricted to arithmetic-only strings (safer, covers the same
    numeric expressions) — anything else is unparseable, as upstream."""
    if isinstance(num, (int, float)):
        return num
    num = _clean_units(num)
    try:
        from videoitg_tpu_torch.eval.tasks.olympiadbench import _parse_latex

        num = str(_parse_latex(num))
    except Exception:
        pass
    if _floatify(num) is not None:
        return _floatify(num)
    if _SAFE_EVAL_RE.match(num):
        try:
            val = eval(num, {"__builtins__": {}}, {})
            if isinstance(val, (list, tuple)):
                return val
            if _floatify(val) is not None:
                return _floatify(val)
        except Exception:
            return None
    return None


def _within_eps(pred, gt):
    eps = abs(gt) * 0.01
    return gt - eps <= pred <= gt + eps


def _compare_two_numbers(p, gt):
    try:
        if math.isnan(p):
            return False
        return _within_eps(p, gt)
    except Exception:
        return False


def _compare_two_list(pred, gt):
    if not isinstance(pred, list) or len(pred) != len(gt):
        return False
    if any(not isinstance(x, (int, float)) for x in pred):
        return False
    return all(_compare_two_numbers(p, g)
               for p, g in zip(sorted(pred), sorted(gt)))


def _remove_latex_math_brackets(latex_str):
    """general_numerical_match.py:148-170."""
    inline = re.compile(r"\\\((.*?)\\\)")
    tex_inline = re.compile(r"$(.*?)$")
    display = re.compile(r"\\\[(.*?)\\\]")
    if any(p.search(latex_str) for p in (inline, tex_inline, display)):
        latex_str = inline.sub(r"\1", latex_str)
        latex_str = display.sub(r"\1", latex_str)
    return latex_str


def _parse_assignment(expression):
    match = re.search(r"(?:=|≈|\\approx)\s*(.+)", expression)
    return match.group(1).strip() if match else expression


class GeneralSingleNumericalMatch:
    @classmethod
    def match(cls, responses, targets):
        """general_numerical_match.py:185-208."""
        if not isinstance(responses, str):
            responses = str(responses)
        responses = _parse_assignment(
            _remove_latex_math_brackets(responses))
        targets = _parse_assignment(_remove_latex_math_brackets(targets))
        res, tgt = _number_it(responses), _number_it(targets)
        if res is not None and tgt is not None:
            # general_numerical_match.py:196-203: list/list pairs (or
            # tuple/tuple, which compare_two_list then rejects — a
            # quirk preserved) go through the sorted-elementwise check.
            if (isinstance(res, list) and isinstance(tgt, list)) or \
                    (isinstance(res, tuple) and isinstance(tgt, tuple)):
                return float(_compare_two_list(res, tgt))
            if isinstance(res, (list, tuple)) \
                    or isinstance(tgt, (list, tuple)):
                return 0.0
            return float(_compare_two_numbers(res, tgt))
        return SimpleStrMatch.match(responses, targets)


class BoxedSingleNumericalMatch:
    _BOXED_RE = re.compile(r"\\boxed\{((?:[^\{\}]+|\{[^\{\}]*\})*)\}")

    @classmethod
    def parse_boxed_content(cls, text):
        match = cls._BOXED_RE.search(text)
        return match.group(1) if match else text

    @classmethod
    def match(cls, responses, targets):
        """general_numerical_match.py:211-240."""
        if not isinstance(responses, str):
            responses = str(responses)
        try:
            parsed_res = cls.parse_boxed_content(responses)
            targets = cls.parse_boxed_content(targets)
            return GeneralSingleNumericalMatch.match(parsed_res, targets)
        except Exception:
            return SimpleStrMatch.match(responses, targets)


# --- geometry -----------------------------------------------------------------

class NbboxIouTuple:
    @classmethod
    def match(cls, responses, targets):
        """nbbox_iou.py:9-36."""
        if not isinstance(responses, (tuple, list)):
            responses = C.str_to_bboxes(responses)
        if not isinstance(targets, (tuple, list)):
            targets = C.str_to_bboxes(targets)
        try:
            iou_scores = C.calculate_iou(responses, targets)
        except Exception:
            return 0
        if not iou_scores:
            return 0
        return sum(iou_scores) / len(iou_scores)


class NbboxIouSingle:
    @classmethod
    def match(cls, responses, targets):
        """nbbox_iou.py:39-68."""
        targets = ast.literal_eval(targets)
        try:
            responses = ast.literal_eval(responses)
        except (SyntaxError, ValueError):
            return 0
        try:
            iou_scores = C.calculate_iou([responses], [targets])
            if not iou_scores:
                return 0
        except Exception:
            return 0
        return sum(iou_scores) / len(iou_scores)


class NbboxIouSequence:
    @classmethod
    def match(cls, responses, targets):
        """nbbox_iou.py:71-105."""
        if not isinstance(responses, (tuple, list)):
            responses = str(responses) if not isinstance(responses, str) \
                else responses
            responses = C.str_to_bboxes(responses)
        if not isinstance(targets, (tuple, list)):
            targets = C.str_to_bboxes(targets)
        if len(targets) != len(responses):
            return 0
        scores = []
        for res, tgt in zip(responses, targets):
            scores.extend(C.calculate_iou([res], [tgt]))
        return sum(scores) / len(scores) if scores else 0


class XmlNbboxIouSingle:
    @classmethod
    def match(cls, responses, targets):
        """xml_nbbox_iou.py."""
        if not isinstance(responses, (tuple, list)):
            responses = C.parse_bboxes_from_xml(responses)
        if not isinstance(targets, (tuple, list)):
            targets = C.parse_bboxes_from_xml(targets)
        if len(responses) == 0:
            return 0
        if isinstance(responses[0], Number) and len(responses) == 4:
            responses = [responses]
        iou_scores = C.calculate_iou(responses, targets)
        if not iou_scores:
            return 0
        return sum(iou_scores) / len(iou_scores)


class XmlNormPointDistance:
    @classmethod
    def _parse_2d_point(cls, point):
        if not isinstance(point, (tuple, list)):
            point = C.parse_point_2d_from_xml(point)
            if not point:
                raise ValueError("Point could not be parsed.")
        elif len(point) != 2:
            raise ValueError("Point is not 2D.")
        if not all(0 <= comp <= 1 for comp in point):
            raise ValueError("Point is not normalized.")
        return tuple(point)

    @classmethod
    def match(cls, responses, targets):
        """xml_norm_point_distance.py."""
        try:
            responses = cls._parse_2d_point(responses)
            targets = cls._parse_2d_point(targets)
        except ValueError:
            return 0
        return max(0, 1 - C.point_distance(responses, targets))


class XmlNormPointInBbox:
    @classmethod
    def match(cls, responses, eval_context):
        """xml_norm_point_in_bbox.py — returns (score, match-info)."""
        bounding_box_has_match = {bbox: False
                                  for bbox in
                                  eval_context["bounding_boxes"]}
        bounding_boxes = [C.str_to_bboxes(b)[0]
                          for b in eval_context["bounding_boxes"]]
        assert bounding_boxes
        if not isinstance(responses, (tuple, list)):
            responses = C.parse_point_2d_from_xml(responses)
            if not responses:
                return 0, bounding_box_has_match
        elif len(responses) != 2:
            return 0, bounding_box_has_match
        x, y = responses
        for min_x, min_y, max_x, max_y in bounding_boxes:
            if min_x <= x <= max_x and min_y <= y <= max_y:
                bounding_box_has_match[
                    str((min_x, min_y, max_x, max_y))] = True
                return 1, bounding_box_has_match
        return 0, bounding_box_has_match


class NormalizedRMSE:
    MIN, MAX = 0.0, 0.1

    @classmethod
    def match(cls, response, correct_answer):
        """mse.py NormalizedRMSE."""
        try:
            val = C.mse(ast.literal_eval(response),
                        ast.literal_eval(correct_answer))
            rmse = min(max(math.sqrt(val), cls.MIN), cls.MAX)
            return 1 - (rmse - cls.MIN) / (cls.MAX - cls.MIN)
        except Exception:
            return 0


class AngleSeqFloatRMSE:
    MIN, MAX = 0.0, 10.0

    @classmethod
    def match(cls, responses, targets):
        """mse.py AngleSeqFloatRMSE."""
        import numpy as np

        responses = C.str_to_list(responses)
        targets = C.str_to_list(targets)
        if len(responses) != len(targets):
            return 0
        try:
            res, tgt = np.array(responses), np.array(targets)
            rmse = np.sqrt(C.mse(res, tgt)).sum() / len(targets)
        except Exception:
            return 0
        rmse = float(np.clip(rmse, cls.MIN, cls.MAX))
        norm = 1 - (rmse - cls.MIN) / (cls.MAX - cls.MIN)
        return 0 if math.isnan(norm) else norm


class CoordsSequenceSimilarity:
    @staticmethod
    def compute_score(pred_keypoints, gt_keypoints, k=10):
        """coordinate_sequence_match.py:14-55."""
        import numpy as np

        try:
            pred = np.array(pred_keypoints)
        except ValueError:
            return 0
        gt = np.array(gt_keypoints)
        if pred.shape != gt.shape:
            return 0
        distances = np.linalg.norm(pred - gt, axis=1)
        normalized = distances / np.sqrt(2)
        return float(np.mean(np.exp(-k * normalized)))

    @classmethod
    def match(cls, responses, targets):
        if not isinstance(responses, (tuple, list)):
            responses = C.str_to_coords(responses, dim=2)
        if not isinstance(targets, (tuple, list)):
            targets = C.str_to_coords(targets, dim=2)
        return cls.compute_score(responses, targets)


# --- program judging -------------------------------------------------------------

class ProgramJudge:
    """program_judge.py — run the predicted python program against
    stdin/stdout test cases in a killable subprocess."""

    TIMEOUT = 2

    @classmethod
    def match(cls, response, eval_context):
        test_cases = eval_context["test_case"]
        if isinstance(test_cases, dict):
            test_cases = [test_cases]
        passed = 0
        for case in test_cases:
            output = cls._run(response, case["input"])
            if output == case["expected"].rstrip():
                passed += 1
        return passed / len(test_cases) if test_cases else 0

    @classmethod
    def _run(cls, user_code, input_data):
        import multiprocessing
        from queue import Empty

        queue = multiprocessing.Queue()
        proc = multiprocessing.Process(
            target=cls._target, args=(queue, user_code,
                                      "\n".join(input_data) + "\n"))
        proc.start()
        proc.join(cls.TIMEOUT)
        if proc.is_alive():
            proc.terminate()
            proc.join()
            return "ERROR: Code execution exceeded the time limit."
        try:
            return queue.get(timeout=10)
        except Empty:
            return "ERROR: No output was produced before timeout."
        finally:
            queue.close()
            queue.join_thread()

    @staticmethod
    def _target(queue, user_code, input_str):
        import io
        from unittest.mock import patch

        stdout = io.StringIO()
        try:
            with patch("builtins.input",
                       side_effect=input_str.splitlines()):
                with patch("sys.stdout", new=stdout):
                    if 'if __name__ == "__main__":' in user_code:
                        exec(user_code, {"__name__": "__main__"})
                    else:
                        exec(user_code)
        except Exception as e:  # noqa: BLE001 - user code may raise anything
            queue.put(f"ERROR during execution: {e}")
        else:
            queue.put(stdout.getvalue().rstrip())


# --- judge-backed metrics ---------------------------------------------------------

def _load_judge_image(path: str):
    """vlm_as_judge.py:44-48 — submission records reference images as
    './data/...' relative to the megabench HF cache; absolute/real paths
    pass through. Returns a PIL image or None if unreadable."""
    import os

    from PIL import Image

    if not os.path.exists(path):
        hf_home = os.path.expanduser(os.getenv("HF_HOME",
                                               "~/.cache/huggingface"))
        path = path.replace("./data/", f"{hf_home}/megabench_data/data/")
    try:
        return Image.open(path)
    except Exception:
        return None


def _pil_to_data_url(image, max_side=1000):
    import base64
    import io

    from PIL import Image

    if image.mode == "RGBA":
        background = Image.new("RGBA", image.size, (255, 255, 255, 255))
        image = Image.alpha_composite(background, image).convert("RGB")
    if max(image.size) > max_side:
        scale = max_side / max(image.size)
        image = image.resize((int(image.size[0] * scale),
                              int(image.size[1] * scale)))
    buf = io.BytesIO()
    image.convert("RGB").save(buf, format="JPEG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/jpeg;base64,{b64}"


def ascii_text_to_image(text, width, height, font_size=20, padding=10,
                        line_spacing=1):
    """conversions.py:193-241 — render ASCII art with a monospace
    font, then resize."""
    from PIL import Image, ImageDraw, ImageFont

    lines = text.splitlines() or [""]
    char_width = font_size * 0.6
    init_width = int(max((len(line) for line in lines), default=1)
                     * char_width + 2 * padding) or 1
    init_height = int(len(lines) * font_size * line_spacing
                      + 2 * padding) or 1
    image = Image.new("RGB", (max(init_width, 1), max(init_height, 1)),
                      color="white")
    draw = ImageDraw.Draw(image)
    font = None
    try:
        from matplotlib import font_manager

        for name in ("DejaVu Sans Mono", "Courier New", "Consolas"):
            try:
                font = ImageFont.truetype(
                    font_manager.findfont(name,
                                          fallback_to_default=False),
                    font_size)
                break
            except (ValueError, OSError):
                continue
    except ImportError:
        pass
    if font is None:
        font = ImageFont.load_default()
    y = padding
    for line in lines:
        draw.text((padding, y), line, font=font, fill="black")
        y += font_size * line_spacing
    return image.resize((width, height), Image.Resampling.LANCZOS)


class VLMJudgeScore:
    """vlm_as_judge.py — the per-task judge prompt (eval_criteria_prompt
    + template_mapping) routed through the pluggable judge backend."""

    def __init__(self, metric_config):
        self.config = metric_config or {}

    def match(self, response, reference_dict, images, question,
              eval_context=None):
        from videoitg_tpu_torch.eval.judge import get_judge

        mapping = {}
        for key, val in self.config.get("template_mapping", {}).items():
            if val == "model_output":
                mapping[key] = response
            elif val == "example_question":
                mapping[key] = question
            elif val.split(".")[0] == "answers":
                mapping[key] = reference_dict[val.split(".")[1]]
            elif val.split(".")[0] == "eval_context":
                mapping[key] = (eval_context or {})[val.split(".")[1]]
        prompt = self.config.get("eval_criteria_prompt", "").format(
            **mapping)
        parts = []
        if self.config.get("judge_model_type") == "with image":
            # Submission records carry raw image PATH strings; the
            # reference judge resolves "./data/" into the HF megabench
            # cache and base64-encodes the file (vlm_as_judge.py:44-55,
            # _update_image_path + create_image_content). PIL images
            # (from in-process callers) are used directly. An unreadable
            # path degrades that one image to text-only (the reference
            # would crash the whole evaluation; documented divergence).
            for img in images or []:
                if isinstance(img, str):
                    img = _load_judge_image(img)
                    if img is None:
                        continue
                if hasattr(img, "size"):
                    parts.append({"type": "image_url",
                                  "image_url":
                                      {"url": _pil_to_data_url(img)}})
        parts.append({"type": "text", "text": prompt})
        try:
            review = get_judge()([{"role": "user", "content": parts}],
                                 max_tokens=1024)
        except Exception:
            return 0, "judge error"
        score_match = re.search(r"\*\*Score\*\*\s*:\s*(\d+)", review)
        expl_match = re.search(r"\*\*Score explanation\*\*\s*:\s*(.*)",
                               review, re.DOTALL)
        explanation = expl_match.group(1).strip() if expl_match else ""
        if score_match is None:
            return 0, f"Score is NULL: {review};"
        score = int(score_match.group(1))
        return score / 10.0, f"Score: {score}; Explanation: {explanation}"


class AsciiArtVLMJudgeScore:
    """ascii_art_vlm_judge.py — render both ASCII arts to images, ask
    the judge whether they depict the same object."""

    PROMPT = ('Determine if the following two ASCII art images depict '
              'the same object. Your answer should be either "yes" or '
              '"no", but without the quotation marks.')

    def __init__(self, metric_config=None):
        self.config = metric_config

    def match(self, response, correct_answer):
        from videoitg_tpu_torch.eval.judge import get_judge

        if not isinstance(response, str) \
                or not isinstance(correct_answer, str) or not response:
            return 0
        parts = [
            {"type": "image_url", "image_url": {"url": _pil_to_data_url(
                ascii_text_to_image(response, 224, 224))}},
            {"type": "image_url", "image_url": {"url": _pil_to_data_url(
                ascii_text_to_image(correct_answer, 224, 224))}},
            {"type": "text", "text": self.PROMPT},
        ]
        try:
            review = get_judge()([{"role": "user", "content": parts}],
                                 max_tokens=16)
        except Exception:
            return 0
        return 1 if "yes" in review.lower() else 0


# --- dependency-gated stand-ins -----------------------------------------------

class NliEntailment:
    """nli_entailment.py needs microsoft/deberta-large-mnli; point
    VIDEOITG_NLI_MODEL at a local checkpoint to enable, else -1
    (excluded from aggregation, the reference's unsupported value)."""

    _pipe = None

    @classmethod
    def match(cls, response, correct_answer):
        import os

        model = os.environ.get("VIDEOITG_NLI_MODEL")
        if not model:
            return -1
        if cls._pipe is None:
            from transformers import pipeline

            cls._pipe = pipeline("text-classification", model=model)
        if not isinstance(response, str) \
                or not isinstance(correct_answer, str):
            return 0
        out = cls._pipe(f"[CLS] {correct_answer.strip()} [SEP] "
                        f"{response.strip()} [SEP]")
        return 1 if out[0]["label"] == "ENTAILMENT" else 0


class GeoProximityLocationDict:
    """geo_proximity.py needs live Nominatim geocoding — no egress in
    this environment; -1 (unsupported/excluded)."""

    @classmethod
    def match(cls, responses, targets):
        return -1


class ConstrainedGenerationEval:
    """constrained_generation.py needs the CMU pronouncing dictionary
    (absent) — -1 (unsupported/excluded)."""

    @classmethod
    def match(cls, response, eval_context):
        return -1, "constrained_generation unsupported offline"


class UnsupportedScoring:
    @staticmethod
    def match(response, correct_answer) -> int:
        return -1


# --- registry -----------------------------------------------------------------

METRICS = {
    "exact_str_match": ExactStrMatch,
    "simple_str_match": SimpleStrMatch,
    "code_result_exact_str_match": CodeResultExactStrMatch,
    "dict_exact_str_match_agg_recall": DictExactStrMatchAggRecall,
    "exact_str_match_case_insensitive": ExactStrMatchCaseInsensitive,
    "normalized_similarity_damerau_levenshtein":
        NormalizedSimilarityDamerauLevenshtein,
    "near_str_match": NearStrMatch,
    "number_rel_diff_ratio": NumberRelDiffRatio,
    "set_equality": SetEquality,
    "set_equality_case_insensitive": SetEqualityCaseInsensitive,
    "dict_set_equality_agg_jaccard": DictSetEqualityAggJaccard,
    "dict_precision": DictPrecision,
    "jaccard_index": Jaccard,
    "jaccard_index_case_insensitive": JaccardCaseInsensitive,
    "dict_jaccard_agg_jaccard": DictJaccardAggJaccard,
    "dict_equality": DictEquality,
    "set_precision": SetPrecision,
    "positive_int_match": PositiveIntMatch,
    "chess_move_list_jaccard_index": ChessMoveJaccard,
    "longest_common_list_prefix_ratio": LongestCommonListPrefixRatio,
    "nli_entailment": NliEntailment,
    "bleu": Bleu,
    "gleu_cn": GLEUChinese,
    "xml_nbbox_iou_single": XmlNbboxIouSingle,
    "latex_expr_equality": LatexExprEquality,
    "text_with_latex_expr_equality": TextLatexExprEquality,
    "nbbox_iou_tuple": NbboxIouTuple,
    "nbbox_iou_single": NbboxIouSingle,
    "nbbox_iou_sequence": NbboxIouSequence,
    "dict_nbbox_iou_tuple_agg_jaccard": DictNbboxIouTupleAggJaccard,
    "xml_norm_point_in_bbox": XmlNormPointInBbox,
    "xml_norm_point_distance": XmlNormPointDistance,
    "geo_proximity_location_dict": GeoProximityLocationDict,
    "normalized_rmse": NormalizedRMSE,
    "program_judge": ProgramJudge,
    "str_set_equality_line_break": StringSetEqualityLineSplit,
    "str_set_equality_comma": StringSetEqualityCommaSplit,
    "sequence_equality": SequenceEquality,
    "sequence_equality_case_insensitive": SequenceEqualityCaseInsensitive,
    "sequence_accuracy_case_insensitive": SequenceAccuracyCaseInsensitive,
    "angle_seq_float_rmse": AngleSeqFloatRMSE,
    "symbolic_planning_test": SymbolicPlanningMetricTest,
    "multi_ref_phrase": MultipleReferencePhraseEval,
    "general_single_numerical_match": GeneralSingleNumericalMatch,
    "boxed_single_numerical_match": BoxedSingleNumericalMatch,
    "sequence_coords_similarity": CoordsSequenceSimilarity,
    "constrained_generation": ConstrainedGenerationEval,
    "gpt_4o_as_judge": VLMJudgeScore,
    "ascii_art_gpt4o_judge": AsciiArtVLMJudgeScore,
    "unsupported": UnsupportedScoring,
}

# Metric families the evaluator dispatches specially
# (evaluator.py:252-287).
CONTEXT_METRICS = {"symbolic_planning_test", "program_judge"}
CONTEXT_INFO_METRICS = {"constrained_generation", "xml_norm_point_in_bbox"}
JUDGE_METRICS = {"gpt_4o_as_judge", "ascii_art_gpt4o_judge"}


def get_metric(name, score_config=None):
    """metric_type.py from_string + _build_metric (evaluator.py:345-355):
    unknown names resolve to UnsupportedScoring; the judge metrics are
    instantiated with the task's gpt4o_eval_configs."""
    key = (name or "unsupported").lower()
    impl = METRICS.get(key, UnsupportedScoring)
    if key in JUDGE_METRICS:
        cfg = (score_config or {}).get("gpt4o_eval_configs")
        return key, impl(cfg)
    return key, impl
