"""Response parsers (parity: lmms_eval/tasks/megabench/metrics/parsing/:
common/utils.py, common/parsers.py, answer_str_parse.py, json_parse.py,
dummy_parse.py, response_parse_type.py)."""

from __future__ import annotations

import ast
import json
import re
from typing import List

PARSING_TIMEOUT = 0.1


def extract_code_block_content(response, code_type=None,
                               is_ascii_art: bool = False,
                               should_remove_surrounding_whitespace=True):
    """common/utils.py:5-38."""
    if code_type:
        pattern = rf"```{code_type}\s*\n*(.*?)\s*```"
    elif is_ascii_art:
        if not response.strip() or len(response) > 10000:
            response = response.rstrip()
        if should_remove_surrounding_whitespace:
            pattern = r"```\w*(?:\s*\n+)?(.*?)\s*```"
        else:
            pattern = r"```\w*(?:\s*\n+)?(.*?)(?:\n+\s*)?```"
    else:
        pattern = r"```\w*\s*\n*(.*?)\s*```"
    match = re.search(pattern, response, flags=re.DOTALL)
    if match:
        if is_ascii_art:
            return match.group(1), True
        return match.group(1).strip(), True
    return response, False


def keep_the_last_answer(s: str) -> str:
    """common/utils.py:41-60."""
    s = s.replace("answer:", "Answer:")
    last_index = s.rfind("Answer:")
    if last_index != -1:
        prefix, suffix = s[:last_index], s[last_index:]
        return prefix.replace("Answer:", "") + suffix
    return s


def extract_answer_content(response, is_ascii_art=False,
                           should_remove_surrounding_whitespace=True):
    """common/utils.py:63-88."""
    response = keep_the_last_answer(response)
    if is_ascii_art:
        match = re.search(r"\*\*?Answer:(.*?)\*\*?|\bAnswer:(.*)",
                          response, re.DOTALL)
    else:
        match = re.search(r"\*\*?Answer:\s*(.*?)\*\*?|\bAnswer:\s*(.*)",
                          response, re.DOTALL)
    if match:
        response = match.group(1) or match.group(2)
        if response is None:
            response = ""
    if is_ascii_art:
        response = re.sub(r"^\s*$(\n^\s*$)+", "", response,
                          flags=re.MULTILINE)
        if should_remove_surrounding_whitespace:
            response = response.rstrip()
        else:
            response = re.sub(r"(\n\s*)+$", "", response)
        response = re.sub(r"^(\s*\n)+", "", response)
    else:
        response = response.strip()
    return response


def extract_answer_at_beginning_of_line(response):
    """common/utils.py:91-100."""
    match = re.search(r"^(?:\*\*Answer:|Answer:)\s*(.+)", response,
                      re.MULTILINE)
    if match:
        return match.group(1).strip()
    return response.strip()


def _is_multiline_answer(text):
    """common/utils.py:117-131."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.strip() != "":
            if i + 1 < len(lines) and lines[i + 1].strip() == "":
                return False
            return True
    return False


def drop_additional_text(result):
    """common/utils.py:103-114."""
    result_first_paragraph = result.split("\n\n")[0].strip()
    potential = re.search(
        r"^(?:(?:[a-zA-Z0-9_-]+)(?:,\s*[a-zA-Z0-9_-]+)*|"
        r"(?:[a-zA-Z0-9_-]+)\.|\((?:[a-zA-Z0-9_-]+)\)$)",
        result_first_paragraph)
    if potential and result_first_paragraph.strip() != "" \
            and not _is_multiline_answer(result):
        return result_first_paragraph
    return result


def evaluate_as_string(s):
    """common/utils.py:134-149."""
    try:
        evaluated = ast.literal_eval(s)
        return evaluated if isinstance(evaluated, str) else s
    except (ValueError, SyntaxError):
        return s
    except MemoryError:
        return ""


def parse_json(response: str):
    """common/parsers.py:15-96 — nested-JSON tolerant extraction via the
    `regex` module's recursive pattern."""
    import regex

    response_ = extract_answer_at_beginning_of_line(response)
    response_, _ = extract_code_block_content(response_, "json")
    json_pattern = r"(\{(?:[^{}]|(?R))*\}|\[(?:[^{}]|(?R))*\])"
    string_pattern = r'"(?:\\.|[^"\\])*"'
    try:
        potential_jsons = regex.findall(json_pattern, response_,
                                        timeout=PARSING_TIMEOUT)
    except TimeoutError:
        return [] if response_.startswith("[") else {}
    valid_jsons = []
    for potential_json in potential_jsons:
        potential_json = potential_json.replace('\\"', "__DOUBLE_QUOTE__")
        potential_json = potential_json.replace("\\'", "__SINGLE_QUOTE__")
        strings = regex.findall(string_pattern, potential_json)
        for s in strings:
            unescaped = s[1:-1].replace("__DOUBLE_QUOTE__", '"') \
                .replace("__SINGLE_QUOTE__", "'")
            try:
                parsed = json.loads(unescaped)
                if isinstance(parsed, (dict, list)):
                    potential_json = potential_json.replace(
                        s, json.dumps(parsed))
            except json.JSONDecodeError:
                pass
        potential_json = potential_json.replace("__DOUBLE_QUOTE__", '\\"')
        potential_json = potential_json.replace("__SINGLE_QUOTE__", "\\'")
        try:
            valid_jsons.append(json.loads(potential_json))
        except json.JSONDecodeError:
            potential_json_ = re.sub(r"(?<!\w)\'|\'(?!\w)", '"',
                                     potential_json)
            try:
                valid_jsons.append(json.loads(potential_json_))
            except json.JSONDecodeError:
                pass
        try:
            valid_jsons.append(ast.literal_eval(potential_json))
            continue
        except (SyntaxError, ValueError):
            pass
        potential_json = potential_json.replace('\\"', '\\\\"')
        potential_json = potential_json.replace("\\'", "\\\\'")
        try:
            valid_jsons.append(ast.literal_eval(potential_json))
        except (SyntaxError, ValueError):
            pass
    if valid_jsons:
        return valid_jsons[-1]
    return [] if response_.startswith("[") else {}


def _answer_str_parse(response, *, is_ascii_art=False,
                      should_remove_surrounding_whitespace=True,
                      is_single_line_ans=None):
    """answer_str_parse.py:17-66."""
    if response is None:
        response = ""
    answer_content = extract_answer_content(
        response, is_ascii_art=is_ascii_art,
        should_remove_surrounding_whitespace=
        should_remove_surrounding_whitespace)
    answer_content, is_code = extract_code_block_content(
        answer_content, is_ascii_art=is_ascii_art,
        should_remove_surrounding_whitespace=
        should_remove_surrounding_whitespace)
    if not is_code and is_single_line_ans and not is_ascii_art:
        answer_content = drop_additional_text(answer_content)
    if answer_content.startswith("{") or answer_content.startswith("["):
        response_obj = parse_json(answer_content)
        if response_obj == {}:
            if "{}" not in answer_content:
                return answer_content
        elif response_obj == []:
            if "[]" not in answer_content:
                return answer_content
        return str(response_obj)
    return evaluate_as_string(answer_content)


def parse_response(parser_name: str, response: str, answer_key=None,
                   is_single_line_ans=None):
    """response_parse_type.py dispatch. Single-field parsers return
    {answer_key: str}; json/dummy return the object / raw string."""
    name = (parser_name or "unsupported").lower()
    if name == "answer_string":
        return {answer_key: _answer_str_parse(
            response, is_single_line_ans=is_single_line_ans)}
    if name == "ascii_answer_string":
        return {answer_key: _answer_str_parse(
            response, is_ascii_art=True,
            is_single_line_ans=is_single_line_ans)}
    if name == "verbatim_answer_string":
        return {answer_key: _answer_str_parse(
            response, is_ascii_art=True,
            should_remove_surrounding_whitespace=False,
            is_single_line_ans=is_single_line_ans)}
    if name == "dummy":
        return response.strip()
    # json + unsupported both route to the JSON parser (evaluator uses
    # the class_impl default, response_parse_type.py:24-36)
    parsed = parse_json(response)
    if isinstance(parsed, dict):
        for key, val in parsed.items():
            parsed[key] = evaluate_as_string(val)
    return parsed


def is_single_field_parser(parser_name: str) -> bool:
    return (parser_name or "").lower() in (
        "answer_string", "ascii_answer_string", "verbatim_answer_string")
