"""OlympiadBench (parity: lmms_eval/tasks/olympiadbench/en_utils.py +
cn_utils.py + olympiadbench_evals.py + the two yamls).

Olympiad math/physics problems with figure(s)
(lmms-lab/OlympiadBench, splits test_en / test_cn). The prompt states
the competition subject, the expected answer type, and demands a
LaTeX \\boxed{...} final answer ("So the final answer is ..." /
"所以最终答案是...", en_utils.py:22-48, cn_utils.py:22-46 — both
templates preserved verbatim).

Scoring (en_utils.py:51-65): proof ("TP" in source) docs are
submission-only (no auto-score upstream either); otherwise the text
after the final-answer marker is stripped and judged against
doc["final_answer"][0] at doc["error"] precision by the
OlympiadBenchEvaluator below — a faithful port of
olympiadbench_evals.py:21-353 (preprocess/boxed extraction/comma split/
plus-minus expansion/pair matching and the numerical -> expression ->
equation -> interval equality chain).

Documented divergence: the reference parses LaTeX with sympy's
antlr4-backed parse_latex (olympiadbench_evals.py:8-9). antlr4 is not
in this image, so expression/equation equality first tries parse_latex
and falls back to an in-tree LaTeX->sympy normalizer (_latex_to_sympy)
covering the constructs that appear in final answers (\\frac, \\sqrt,
\\cdot/\\times, ^{}, \\pi, e^{}, braces). Exact-string and pure-numeric
equality (the dominant path: most final answers are numbers) is
dependency-free and exact.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

# evals.py:24-37
SPECIAL_SIGNAL_MAP = {
    "\\left": "",
    "\\right": "",
    "∶": ":",
    "，": ",",
    "$": "",
    "\\approx": "=",
    "\\simeq": "=",
    "\\sim": "=",
    "^\\prime": "'",
    "^{\\prime}": "'",
    "^\\circ": "",
    "%": "",
}

_MATHRM_RE = re.compile(r"\\(?:mathrm|mathbf)\{~?([^}]*)\}")


def _parse_latex(expr: str):
    """parse_latex when antlr4 exists, else the in-tree normalizer."""
    try:  # pragma: no cover - antlr4 not in this image
        from sympy.parsing.latex import parse_latex

        return parse_latex(expr)
    except ImportError:
        return _latex_to_sympy(expr)


def _latex_to_sympy(expr: str):
    """Minimal LaTeX -> sympy for final-answer expressions (divergence
    note in the module docstring)."""
    import sympy as sp
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    s = expr
    # \frac{a}{b}, \dfrac, \tfrac -> ((a)/(b)); innermost-first loop so
    # nested fracs resolve.
    frac = re.compile(r"\\[dt]?frac\{([^{}]*)\}\{([^{}]*)\}")
    for _ in range(10):
        s2 = frac.sub(r"((\1)/(\2))", s)
        if s2 == s:
            break
        s = s2
    # \frac12 shorthand
    s = re.sub(r"\\[dt]?frac(\d)(\d)", r"((\1)/(\2))", s)
    # \sqrt[n]{x} and \sqrt{x}
    for _ in range(10):
        s2 = re.sub(r"\\sqrt\[([^\]]*)\]\{([^{}]*)\}", r"((\2)**(1/(\1)))", s)
        s2 = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s2)
        if s2 == s:
            break
        s = s2
    s = re.sub(r"\\sqrt(\d)", r"sqrt(\1)", s)
    s = s.replace("\\cdot", "*").replace("\\times", "*")
    s = s.replace("\\pi", "pi").replace("\\infty", "oo")
    s = s.replace("\\ln", "log").replace("\\log", "log")
    s = re.sub(r"\\(sin|cos|tan|exp)", r"\1", s)
    s = s.replace("\\%", "").replace("\\,", "").replace("\\!", "")
    s = s.replace("\\ ", " ")
    # exponents: ^{...} -> **(...), ^x -> **x
    s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
    s = s.replace("^", "**")
    # remaining grouping braces become parentheses
    s = s.replace("{", "(").replace("}", ")")
    transformations = standard_transformations + (
        implicit_multiplication_application,)
    return parse_expr(s, transformations=transformations,
                      local_dict={"pi": sp.pi, "e": sp.E})


class OlympiadBenchEvaluator:
    """olympiadbench_evals.py:21-353."""

    def __init__(self):
        self.precision = 1e-8

    # evals.py:41-58
    def split_by_comma(self, expr: str) -> List[str]:
        in_bracket = 0
        out, start = [], 0
        for i, ch in enumerate(expr):
            if ch in "([":
                in_bracket += 1
            elif ch in ")]":
                in_bracket -= 1
            elif ch == "," and in_bracket == 0:
                out.append(expr[start:i].strip())
                start = i + 1
        if start < len(expr):
            out.append(expr[start:].strip())
        return out

    # evals.py:60-70
    def trans_plus_minus_sign(self, exprs: List[str]) -> List[str]:
        out = []
        for e in exprs:
            if "\\pm" in e:
                out.append(e.replace("\\pm", "+"))
                out.append(e.replace("\\pm", "-"))
            else:
                out.append(e)
        return out

    # evals.py:72-120
    def judge(self, expression1: str, expression2: str,
              precision=1e-8) -> bool:
        precision = precision if isinstance(precision, list) else [precision]
        try:
            expression1, expression2 = self.preprocess(expression1,
                                                       expression2)
        except Exception:
            return False
        if expression1 == expression2:
            return True
        expression1 = re.sub(r"[\u4e00-\u9fff]+", "", expression1)
        expression2 = re.sub(r"[\u4e00-\u9fff]+", "", expression2)
        list1 = self.trans_plus_minus_sign(self.split_by_comma(expression1))
        list2 = self.trans_plus_minus_sign(self.split_by_comma(expression2))
        if len(precision) <= 1:
            precision = precision * len(list1)
        if len(list1) != len(list2):
            return False
        idx = -1
        while len(list1) != 0:
            idx = (idx + 1) % len(list1)
            item1 = list1[idx]
            self.precision = precision[idx]
            for item2 in list2:
                if self.is_equal(item1, item2):
                    list1.remove(item1)
                    list2.remove(item2)
                    precision.remove(self.precision)
                    break
            else:
                return False
        return True

    # evals.py:122-124
    def is_interval(self, expr: str) -> bool:
        return expr.startswith(("(", "[")) and expr.endswith((")", "]"))

    # evals.py:130-166
    def is_equal(self, expression1: str, expression2: str) -> bool:
        if expression1 == expression2 and expression1 != "" \
                and expression2 != "":
            return True
        if self.is_interval(expression1) and self.is_interval(expression2):
            try:
                if self.interval_equal(expression1, expression2):
                    return True
            except Exception:
                return False
        try:
            if self.numerical_equal(expression1, expression2):
                return True
        except Exception:
            pass
        try:
            if self.expression_equal(expression1, expression2) and not (
                    "=" in expression1 and "=" in expression2):
                return True
        except Exception:
            pass
        try:
            if self.equation_equal(expression1, expression2):
                return True
        except Exception:
            pass
        return False

    # evals.py:168-180
    def numerical_equal(self, expression1: str, expression2: str,
                        include_percentage: bool = True) -> bool:
        reference = float(expression1)
        prediction = float(expression2)
        gt_result = ([reference / 100, reference, reference * 100]
                     if include_percentage else [reference])
        for item in gt_result:
            if abs(item - prediction) <= self.precision * 1.01:
                return True
        return False

    # evals.py:182-223
    def expression_equal(self, exp1: str, exp2: str) -> bool:
        import sympy as sp
        from sympy import simplify, sympify

        def extract_expression(expression):
            if "=" in expression:
                expression = expression.split("=")[1]
            return expression.strip()

        exp1, exp2 = extract_expression(exp1), extract_expression(exp2)
        expr1_sym = sympify(_parse_latex(exp1))
        expr2_sym = sympify(_parse_latex(exp2))
        if expr1_sym == expr2_sym:
            return True
        expr1_sym = expr1_sym.subs(sp.pi, math.pi)
        expr2_sym = expr2_sym.subs(sp.pi, math.pi)
        has1, has2 = expr1_sym.has(sp.Symbol), expr2_sym.has(sp.Symbol)
        if has1 != has2:
            return False
        if not has1 and not has2:
            if not (self.can_compute_power(expr1_sym)
                    and self.can_compute_power(expr2_sym)):
                return False
            try:
                return abs(expr1_sym.evalf() - expr2_sym.evalf()) \
                    <= self.precision * 1.01
            except Exception:
                return False
        try:
            simplified = simplify(expr1_sym - expr2_sym)
            return abs(simplified.evalf()) < 1e-3
        except Exception:
            return False

    # evals.py:225-249
    def equation_equal(self, expression1: str, expression2: str) -> bool:
        from sympy import simplify

        def simplify_equation(latex_eq):
            lhs, rhs = latex_eq.split("=")
            return simplify(_parse_latex(lhs) - _parse_latex(rhs))

        expr1_sym = simplify_equation(expression1)
        expr2_sym = simplify_equation(expression2)
        div1 = simplify(expr1_sym / expr2_sym)
        div2 = simplify(expr2_sym / expr1_sym)
        return bool((div1.is_Integer and div1 != 0)
                    or (div2.is_Integer and div2 != 0))

    # evals.py:251-282
    def interval_equal(self, expression1: str, expression2: str) -> bool:
        def compare_two_interval(inter1, inter2):
            if inter1[0] != inter2[0] or inter1[-1] != inter2[-1]:
                return False
            items_1 = inter1.strip("[]()").split(",")
            items_2 = inter2.strip("[]()").split(",")
            for item_1, item_2 in zip(items_1, items_2):
                if not self.expression_equal(item_1, item_2):
                    return False
            return True

        if expression1 == expression2:
            return True
        inter_list1 = expression1.split("\\cup")
        inter_list2 = expression2.split("\\cup")
        if len(inter_list1) != len(inter_list2):
            return False
        for inter1, inter2 in zip(inter_list1, inter_list2):
            if not compare_two_interval(inter1, inter2):
                return False
        return True

    # evals.py:284-338
    def preprocess(self, expression1: str, expression2: str):
        def extract_boxed_content(latex_str):
            boxed_matches = re.finditer(r"\\boxed\{", latex_str)
            results = ""
            for match in boxed_matches:
                start_index = match.end()
                end_index = start_index
                stack = 1
                while stack > 0 and end_index < len(latex_str):
                    if latex_str[end_index] == "{":
                        stack += 1
                    elif latex_str[end_index] == "}":
                        stack -= 1
                    end_index += 1
                if stack == 0:
                    results += latex_str[start_index:end_index - 1] + ","
                else:
                    raise ValueError("Mismatched braces in LaTeX string.")
            if results == "":
                last_line_ans = latex_str.strip().split("\n")[-1]
                answers = re.findall(r"\$(.*?)\$", last_line_ans)
                if answers:
                    for ans in answers:
                        results += ans + ","
                else:
                    results = latex_str
            return results

        def special_symbol_replace(expression):
            if "\\in " in expression:
                expression = expression.split("\\in ")[1]
            for signal, repl in SPECIAL_SIGNAL_MAP.items():
                expression = expression.replace(signal, repl)
            expression = expression.strip("\n$,.:;^_=+`!@#$%^&*~，。")
            return _MATHRM_RE.sub(r"\1", expression)

        exp1 = special_symbol_replace(extract_boxed_content(expression1))
        exp2 = special_symbol_replace(extract_boxed_content(expression2))
        return exp1, exp2

    # evals.py:340-353
    def can_compute_power(self, expr) -> bool:
        from sympy import Pow

        if isinstance(expr, Pow):
            base, exp = expr.as_base_exp()
            if base.is_number and exp.is_number:
                return abs(exp.evalf()) <= 1000
            return False
        return True


_EVALUATOR = OlympiadBenchEvaluator()


def doc_to_visual(doc, data_root: str = ""):
    """en_utils.py:18-19."""
    return list(doc["images"])


def doc_to_text_en(doc) -> str:
    """en_utils.py:22-48 — verbatim template."""
    question = doc["question"]
    subject = doc["subfield"]
    mul_ans = doc["is_multiple_answer"] or False
    ans_type = doc["answer_type"]
    if ans_type == "Need_human_evaluate":
        ans_type = "proof based"
    pre_prompt = (f"The following is a question from an International "
                  f"{subject} competition.\n")
    post_prompt = ""
    if not mul_ans:
        post_prompt += f"The answer of the question should be {ans_type}.\n"
    else:
        post_prompt += (f"The question has multiple answers, each of them "
                        f"should be {ans_type}.\n")
    post_prompt += (
        "Please calculate the answer according to the given requirements "
        "and the information provided. Please use LaTeX format to "
        "represent the variables and formulas used in the solution "
        "process and results. Please end your solution with ")
    if not mul_ans:
        post_prompt += '"So the final answer is \\boxed{answer}."\n'
    else:
        post_prompt += ("So the final answer is \\boxed{multiple answers "
                        "connected with commas}.\n")
    return pre_prompt + question + "\n" + post_prompt


def doc_to_text_cn(doc) -> str:
    """cn_utils.py:22-46 — verbatim template."""
    question = doc["question"]
    subject = doc["subfield"]
    mul_ans = doc["is_multiple_answer"] or False
    ans_type = doc["answer_type"]
    if ans_type == "Need_human_evaluate":
        ans_type = "proof based"
    pre_prompt = f"以下是中国{subject}竞赛中的解答题。\n"
    post_prompt = ""
    if not mul_ans:
        post_prompt += f"答案类型为{ans_type}。\n"
    else:
        post_prompt += f"题目有多个答案，答案类型均为{ans_type}。\n"
    post_prompt += ("请根据题目的要求和所提供的信息计算得出答案。解答过程和结果中使用的变量和公式请使用LaTeX"
                    "格式表示。请在最后以")
    if not mul_ans:
        post_prompt += '"所以最终答案是\\boxed{答案}。"\n'
    else:
        post_prompt += '"所以最终答案是\\boxed{用英⽂逗号连接的多个答案}。"\n'
    return pre_prompt + question + "\n" + post_prompt


def _make_process(marker: str):
    def process_results(doc, response: str) -> dict:
        """en_utils.py:51-65 / cn_utils.py:49-63."""
        precision = doc["error"]
        is_proving = "TP" in doc["source"]
        if precision is None:
            precision = 0
        prediction = response.strip()
        if is_proving:
            return {"submission": prediction, "scored": False}
        prediction = prediction.split(marker)[-1]
        prediction = (prediction.replace('"', "").replace("\n", "")
                      .replace(" ", "").strip(".").strip("。"))
        accuracy = int(_EVALUATOR.judge(prediction,
                                        doc["final_answer"][0], precision))
        return {"exact_match": accuracy, "scored": True}
    return process_results


def aggregate(records: List[dict]) -> Dict[str, float]:
    """The reference aggregator only writes a submission file
    (en_utils.py:68-75); the returned metric here is the mean
    exact_match over auto-scorable (non-proof) docs, which is the
    number the leaderboard computes from that file."""
    scored = [r["exact_match"] for r in records if r.get("scored")]
    out = {"exact_match": sum(scored) / len(scored) if scored else 0.0,
           "scored_docs": float(len(scored)),
           "submission_docs": float(len(records) - len(scored))}
    return out


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/OlympiadBench", data_root,
                                   split_)
    return load_docs


_GEN = {"max_new_tokens": 1024, "temperature": 0, "do_sample": False}

register_task(Task(
    name="olympiadbench_test_en",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text_en,
    doc_to_target=lambda doc: ",".join(doc.get("final_answer") or []),
    process_results=_make_process("final answer is"),
    aggregate=aggregate,
    primary_metric="exact_match",
    load_docs=_make_load("test_en"),
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="olympiadbench_test_cn",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text_cn,
    doc_to_target=lambda doc: ",".join(doc.get("final_answer") or []),
    process_results=_make_process("所以最终答案是"),
    aggregate=aggregate,
    primary_metric="exact_match",
    load_docs=_make_load("test_cn"),
    generation_kwargs=dict(_GEN),
))

register_group("olympiadbench", ["olympiadbench_test_en",
                                 "olympiadbench_test_cn"])
