"""CMMMU (parity: lmms_eval/tasks/cmmmu/utils.py +
cmmmu_{val,test}.yaml; group _cmmmu.yaml).

Chinese MMMU over lmms-lab/CMMMU. Docs carry id / type
(选择 MCQ | 判断 T/F | 填空 fill-in) / question / option1..4 /
answer / subcategory / image_1..image_5 (+ *_filename fields the
prompt rewrites into <图片 N> slots).

Parity:
* construct_prompt (utils.py:11-53): per-type Chinese task
  instruction + example template; every <img="{filename}"> token is
  rewritten to <图片 N>.
* visuals (utils.py:60-66): the <图片 N> slots the prompt references,
  in order of appearance.
* answer parsing (utils.py:220-420): MCQ — OCCURRENCE-COUNTED votes
  over "(A)" then bare "A" then option text, most-frequent candidates
  CONCATENATED in ABCD order (multi-select support); the no-candidate
  fallback is a deterministic crc32 draw standing in for the
  reference's random.choice (same convention as tasks/mmmu.py).
  Fill-in — Chinese key-indicator tail extraction + number
  normalization (with the 长度 sanity filter len > len(answer)+20 /
  letters > +2 -> dropped). T/F — key extraction then
  positive/negative keyword voting with the ambiguous-keyword filter;
  vote ties fall to the crc32 draw (reference: random).
* scoring (utils.py:144-215): MCQ exact match on the concatenated
  letters; fill-in normalized containment; T/F 对/错 equality.
  Aggregation: per-subcategory counts -> Chinese domain rollups ->
  overall micro accuracy (round 3).
* test split is submission-only (id/type/response rows).
"""

from __future__ import annotations

import re
import zlib
from collections import Counter, defaultdict
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

TASK_INSTRUCTIONS = [
    "请回答以下多项选择题，并选出正确选项。这些题目可能包括单选和多选题型。如果所提供的信息不足以确定一个明确的答案，那么请根据可用的数据和你的判断来选择最可能正确的选项。",
    "请回答以下判断题，并根据题目描述和所给的信息来判断问题中陈述的对错。如果信息不完整或不足以作出绝对判断，请运用你的逻辑推理和现有信息来做出最可能的判断。",
    "请回答以下填空题，并根据题目的要求和所提供的信息来给出最恰当的答案。如果信息不足以确切回答，那么请依据现有的数据和你的推理能力来填写最合理的答案。",
]

DOMAIN_CAT2SUB_CAT = {
    "艺术与设计": ["艺术", "艺术理论", "设计", "音乐"],
    "商业": ["会计", "经济", "金融", "管理", "营销"],
    "科学": ["生物", "化学", "地理", "数学", "物理"],
    "健康与医学": ["基础医学", "临床医学", "诊断学与实验室医学", "制药",
                   "公共卫生"],
    "人文社会科学": ["历史", "文献学", "社会学", "心理学"],
    "技术与工程": ["农业", "建筑学", "计算机科学", "电子学", "能源和电力",
                   "材料", "机械工程"],
}

POSITIVE_KEYWORDS = ["正确", "对", "准确", "肯定", "对的"]
NEGATIVE_KEYWORDS = ["不对", "错误", "不正确", "不准确", "不合适", "否定",
                     "错的", "错"]
AMBIGUOUS_KEYWORDS = ["对错", "是否正确", "否正确", "或者", "是否", "正确性",
                      "对不"]


def _crc_choice(options: List[str], seed: str) -> str:
    return options[zlib.crc32(seed.encode()) % len(options)]


def construct_prompt(doc) -> str:
    """utils.py:22-53."""
    q = doc["question"]
    if doc["type"] == "选择":
        opts = "".join(f"({chr(ord('A') + i - 1)}) {doc[f'option{i}']}\n"
                       for i in range(1, 5))
        prompt = (TASK_INSTRUCTIONS[0] + "\n\n"
                  + f"问题：{q}\n选项：\n{opts}正确答案：\n")
    elif doc["type"] == "判断":
        prompt = TASK_INSTRUCTIONS[1] + "\n\n" + f"问题：{q}\n正确答案：\n"
    else:
        prompt = TASK_INSTRUCTIONS[2] + "\n\n" + f"问题：{q}\n正确答案：\n"
    for i in range(1, 6):
        fname = doc.get(f"image_{i}_filename")
        if fname:
            prompt = prompt.replace(f'<img="{fname}">', f"<图片 {i}>")
    return prompt


def doc_to_text(doc) -> str:
    return construct_prompt(doc)


def doc_to_visual(doc, data_root: str = ""):
    import os

    prompt = construct_prompt(doc)
    tokens = [t.strip("<>").replace(" ", "_").replace("图片", "image")
              for t in re.findall(r"<图片 \d+>", prompt)]
    out = []
    for t in tokens:
        v = doc[t]
        if hasattr(v, "convert"):
            out.append(v)
            continue
        p = os.path.join(data_root, v) if data_root else v
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        out.append(p)
    return out


def get_multi_choice_prediction(response: str, all_choices: List[str],
                                index2ans: Dict[str, str],
                                doc_id: str = "") -> str:
    """utils.py:220-258 (random fallback -> crc32)."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "
    candidates: List[str] = []
    for c in all_choices:
        candidates.extend([c] * response.count(f"({c})"))
    if not candidates:
        for c in all_choices:
            candidates.extend([c] * response.count(c))
    if not candidates and len(response.split()) >= 1:
        for idx, ans in index2ans.items():
            candidates.extend([idx] * response.count(ans))
    if not candidates and len(response.split()) >= 1:
        for idx, ans in index2ans.items():
            if ans in response:
                candidates.append(idx)
    if not candidates:
        return _crc_choice(all_choices, f"{doc_id}|{response}")
    counts = Counter(candidates)
    max_count = max(counts.values())
    return "".join(c for c in all_choices if counts.get(c, 0) == max_count)


def extract_numbers(s: str) -> List[str]:
    """utils.py:261-277 (Chinese full-width comma variant)."""
    commas = re.findall(r"-?\d{1,3}(?:，\d{3})+", s)
    scientific = re.findall(r"-?\d+(?:\.\d+)?[eE][+-]?\d+", s)
    simple = re.findall(r"-?(?:\d+\.\d+|\.\d+|\d+)(?![eE][+-]?\d+)(?!，\d)",
                        s)
    return commas + scientific + simple


def _count_letters(s: str) -> int:
    return sum("a" <= c <= "z" or "A" <= c <= "Z" for c in s)


def normalize_str(string, answer):
    """utils.py:293-313."""
    if string is None:
        return [string]
    string = string.strip()
    try:
        num = float(string.replace(",", ""))
        return [round(num, 2)]
    except ValueError:
        pass
    if (len(string) > len(answer) + 20
            or _count_letters(string) > _count_letters(answer) + 2):
        return []
    return [string]


def _key_subresponses(response: str, indicators: List[str],
                      eq_on_last: bool) -> List[str]:
    response = response.strip("。").strip()
    subs = re.split(r"。|\n", response)
    out = []
    for i, resp in enumerate(subs):
        inds = list(indicators)
        if eq_on_last and i == len(subs) - 1:
            inds.append("=")
        shortest = None
        for ind in inds:
            if ind in resp:
                tail = resp.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in [":", ",", ".", "!", "?",
                                                 ";", ":", "'"]:
            out.append(shortest)
    return out or [response]


def get_fill_blank_prediction(response: str, answer) -> list:
    """utils.py:316-361."""
    keys = _key_subresponses(
        response, ["是", "为", "所以", "等于", "方案", "选择", "正确答案",
                   "因此", "最后", "答案", "结果"], eq_on_last=True)
    pred_list = list(keys)
    for resp in keys:
        pred_list.extend(extract_numbers(resp))
    out = []
    for p in pred_list:
        out.extend(normalize_str(p, answer))
    return list(set(out))


def get_TF_prediction(response: str) -> list:
    """utils.py:364-398."""
    keys = _key_subresponses(
        response, ["是", "为", "所以", "判断", "陈述", "说法", "表达",
                   "答案", "结果"], eq_on_last=False)
    return list(set(keys))


def _tf_judge(pred_list: List[str], seed: str) -> str:
    """utils.py:176-198 (random tiebreak -> crc32)."""
    pred_list = [p for p in pred_list
                 if not any(a in p for a in AMBIGUOUS_KEYWORDS)]
    pos = sum(any(w in p for w in POSITIVE_KEYWORDS) for p in pred_list)
    neg = sum(any(w in p for w in NEGATIVE_KEYWORDS)
              for p in pred_list
              if not any(w in p for w in POSITIVE_KEYWORDS))
    if pos > neg:
        return "对"
    if neg > pos:
        return "错"
    return _crc_choice(["对", "错"], seed)


def process_results(doc, response: str) -> dict:
    if doc["type"] == "选择":
        options = [doc[f"option{i}"] for i in range(1, 5)]
        letters = [chr(ord("A") + i) for i in range(4)]
        parsed = get_multi_choice_prediction(
            response, letters, dict(zip(letters, options)),
            doc_id=str(doc["id"]))
    elif doc["type"] == "判断":
        parsed = get_TF_prediction(response)
    else:
        parsed = get_fill_blank_prediction(response, doc["answer"])
    return {"id": doc["id"], "subdomain": doc["subcategory"],
            "question_type": doc["type"], "answer": doc["answer"],
            "parsed_pred": parsed}


def _is_correct(r: dict) -> bool:
    """eval_cmmmu per-entry logic (utils.py:144-206)."""
    if r["question_type"] == "选择":
        return r["parsed_pred"] == r["answer"]
    if r["question_type"] == "填空":
        norm_answers = normalize_str(r["answer"], r["answer"])
        for pred in r["parsed_pred"]:
            if isinstance(pred, str):
                if any(isinstance(a, str) and a in pred
                       for a in norm_answers):
                    return True
            elif pred in norm_answers:
                return True
        return False
    return _tf_judge(r["parsed_pred"],
                     f"{r['id']}|{r['parsed_pred']}") == r["answer"]


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"cmmmu_acc": 0.0}
    by_sub = defaultdict(list)
    for r in records:
        by_sub[r["subdomain"]].append(float(_is_correct(r)))
    total = sum(len(v) for v in by_sub.values())
    correct = sum(sum(v) for v in by_sub.values())
    out = {"cmmmu_acc": round(correct / total, 3)}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        present = [by_sub[c] for c in cats if c in by_sub]
        if present:
            n = sum(len(v) for v in present)
            out[f"cmmmu_{domain}"] = round(
                sum(sum(v) for v in present) / n, 3)
    for s in sorted(by_sub):
        out[f"cmmmu_{s}"] = round(sum(by_sub[s]) / len(by_sub[s]), 3)
    return out


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("lmms-lab/CMMMU", data_root, split_)
    return load_docs


_GEN = {"max_new_tokens": 16, "temperature": 0, "do_sample": False}

register_task(Task(
    name="cmmmu_val",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="cmmmu_acc",
    load_docs=_make_load("val"),
    generation_kwargs=dict(_GEN),
))

register_task(Task(
    name="cmmmu_test",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=lambda doc, response: {
        "id": doc["id"], "type": doc["type"], "response": response},
    aggregate=lambda rs: {"submission_rows": float(len(rs))},
    load_docs=_make_load("test"),
    generation_kwargs=dict(_GEN),
))
