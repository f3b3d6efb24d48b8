"""MMSearch (parity: lmms_eval/tasks/mmsearch/: lmms_eval_utils.py,
prompts/prompt.py + prompt_w_imagesearch.py, score/{f1_score,req_score,
result_summary}.py, utils/{prompt_utils,utils,image_utils}.py,
constants.py, the three yamls and get_final_scores.py).

Three tasks over CaraJ/MMSearch:

* ``mmsearch_rerank`` (split rerank) — pick the most helpful website
  from 8 given (title/snippet/screenshot in the doc); fully offline.
  Scoring: postprocess_rerank's "<Website k>" extraction, 1 for a
  valid index, 0.5 for not_sure, 0 otherwise
  (lmms_eval_utils.py:394-430).
* ``mmsearch_summarization`` (split summarization) — answer from ONE
  retrieved website (title/snippet/retrieved content/slimmed fullpage
  screenshot in the doc); fully offline. Scoring: token-level QA F1 vs
  gt_answer and every alternative (max, lmms_eval_utils.py:339-357).
* ``mmsearch_end2end`` (split end2end) — the 3-round requery -> rerank
  -> summarize agent loop. The LIVE pieces (DuckDuckGo search +
  playwright screenshots + BGE-M3 content retrieval,
  utils/utils.py:59-230, retrieve_content/retriever.py) are behind the
  pluggable ``SearchBackend`` — no egress offline, so the
  default backend raises with this note; ``run_end2end`` implements the
  reference's full round protocol (lmms_eval_utils.py:40-166) against
  any backend and is exercised in tests with a fake. Registered
  single-round behavior produces the stage-1 requery (round_idx=None
  contract). NOTE the reference's own VideoITG-path wrappers never
  implement generate_until_multi_round either (they delegate to
  generate_until) — the explicit driver here exceeds that.

Score helpers are exact ports: QA F1 (SQuAD normalization,
f1_score.py), requery score = mean of smoothed BLEU-1 + rouge-l F
(req_score.py; nltk + the `rouge` package, both in-image), and the
area/subfield result summary (result_summary.py — returned as metric
keys instead of written JSON files). All six prompt templates are
verbatim behavioral constants.
"""

from __future__ import annotations

import collections
import re
import string
from typing import Callable, Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_group, register_task

DEFAULT_IMAGE_TOKEN = "<image>"
BRIEF_RESULT_NUM = 8   # lmms_eval_utils.py:35
FULLPAGE_NUM = 1       # lmms_eval_utils.py:36
FULLPAGE_SPLIT_DICT = {"slice_height": 512, "max_slices": 10}

# --- prompts (prompts/prompt.py + prompt_w_imagesearch.py, verbatim) ---------

STAGE1_TEXT = """You are a helpful assistant. I am giving you a question, which cannot be solved without external knowledge.
Assume you have access to a text-only search engine (e.g., google). Please raise a query to the search engine to search for what is useful for you to answer the question correctly. Your query needs to consider the attribute of the query to search engine.
Here are 3 examples:
Question: Did Zheng Xiuwen wear a knee pad in the women's singles tennis final in 2024 Paris Olympics?
Query to the search engine: Images of Zheng Xiuwen in the women's singles tennis final in 2024 Paris Olympics

Question: When will Apple release iPhone16?
Query to the search engine: iPhone 16 release date

Question: Who will sing a French song at the Olympic Games closing ceremony?
Query to the search engine: Singers at the Olympic Games closing ceremony, French song

Question: {question}
Query to the search engine (do not involve any explanation): """

STAGE2_TEXT = """You are a helpful assistant. I am giving you a question and {brief_result_num} website information related to the question (including the screenshot, snippet and title).
You should now read the screenshots, snippets and titles. Select {rerank_num} website that are the most helpful for you to answer the question. Once you select it, the detailed content of them will be provided to help you correctly answer the question.
The question is: {question}
The website informations is:
{website_information}

You should directly output {rerank_num} website's index that can help you most, separated with ',', and enclose each website in angle brackets. The output format should be: <Website Index>.
An example of the output is: {incontext_example}
Your answer: """

STAGE3_TEXT = """You are a helpful assistant. I am giving you a question and {rerank_num} website information related to the question.
Please follow these guidelines when formulating your answer:
1. If the question contains a false premise or assumption, answer "invalid question".
2. When answering questions about dates, use the yyyy-mm-dd format.
3. Answer the question with as few words as you can.

You should now read the information of the website and answer the question.
The website informations is {website_information}
The question is: {question}.
Please directly output the answer without any explanation: """

STAGE1_IMG = """You are a helpful assistant. I am giving you a question including an image, which cannot be solved without external knowledge.
Assume you have access to a search engine (e.g., google). Please raise a query to the search engine to search for what is useful for you to answer the question correctly. You need to consider the characteristics of asking questions to search engines when formulating your questions.
You are also provided with the search result of the image in the question. You should leverage the image search result to raise the text query.
Here are 3 examples:
Question: Did Zheng Xiuwen wear a knee pad in the women's singles tennis final in 2024 Paris Olympics?
Query to the search engine: Images of Zheng Xiuwen in the women's singles tennis final in 2024 Paris Olympics

Question: When will Apple release iPhone16?
Query to the search engine: iPhone 16 release date

Question: Who will sing a French song at the Olympic Games closing ceremony?
Query to the search engine: Singers at the Olympic Games closing ceremony, French song

Question: {question}
The image search result is: {image_search_result}
Query to the search engine (do not involve any explanation): """

STAGE2_IMG = """You are a helpful assistant. I am giving you a question including an image. You are provided with the search result of the image in the question. And you are provided with {brief_result_num} website information related to the question (including the screenshot, snippet and title).
You should now read the screenshots, snippets and titles of these websites. Select {rerank_num} website that are the most helpful for you to answer the question. Once you select it, the detailed content of them will be provided to help you correctly answer the question.
The question is: {question}
The image search result is: {image_search_result}
The website informations is:
{website_information}

You should directly output {rerank_num} website's index that can help you most, separated with ',', and enclose each website in angle brackets. The output format should be: <Website Index>.
An example of the output is: {incontext_example}
Your answer: """

STAGE3_IMG = """You are a helpful assistant. I am giving you a question including an image. You are provided with the search result of the image in the question. And you are provided with {rerank_num} website information related to the question.
Please follow these guidelines when formulating your answer:
1. If the question contains a false premise or assumption, answer "invalid question".
2. When answering questions about dates, use the yyyy-mm-dd format.
3. Answer the question with as few words as you can.

You should now read the information of the website and answer the question.
The website informations is {website_information}
The image search result is: {image_search_result}
The question is: {question}.
Please directly output the answer without any explanation: """

def _restore_trailing(template: str, line_indices) -> str:
    """The reference templates carry TRAILING SPACES on these lines
    (part of the prompt bytes, hence the metric); they are restored
    here declaratively so whitespace-stripping tooling can't silently
    change them. Byte parity is pinned by
    tests/test_r5_mmsearch.py::test_prompts_byte_exact."""
    lines = template.split("\n")
    for i in line_indices:
        lines[i] += " "
    return "\n".join(lines)


# The final "...: " line keeps its trailing space in the literal above;
# only the mid-template ones (strippable by tooling) are restored.
STAGE1_TEXT = _restore_trailing(STAGE1_TEXT, (1, 7, 12))
STAGE2_TEXT = _restore_trailing(STAGE2_TEXT, (0, 3, 6))
STAGE3_TEXT = _restore_trailing(STAGE3_TEXT, (0,))
STAGE1_IMG = _restore_trailing(STAGE1_IMG, (1, 8, 13))
STAGE2_IMG = _restore_trailing(STAGE2_IMG, (0, 4, 7))
STAGE3_IMG = _restore_trailing(STAGE3_IMG, (0,))

TEXT_QUERY_DICT = {"stage1": STAGE1_TEXT, "stage2": STAGE2_TEXT,
                   "stage3": STAGE3_TEXT}
IMAGE_QUERY_DICT = {"stage1": STAGE1_IMG, "stage2": STAGE2_IMG,
                    "stage3": STAGE3_IMG}


# --- score helpers ------------------------------------------------------------

def normalize_answer(s: str) -> str:
    """f1_score.py:6-23 — SQuAD normalization."""
    s = "".join(ch for ch in s.lower() if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def get_f1_score(a_pred: str, a_gold: str) -> float:
    """f1_score.py:26-47."""
    gold_toks = normalize_answer(a_gold).split() if a_gold else []
    pred_toks = normalize_answer(a_pred).split() if a_pred else []
    common = collections.Counter(gold_toks) & collections.Counter(pred_toks)
    num_same = sum(common.values())
    if len(gold_toks) == 0 or len(pred_toks) == 0:
        return int(gold_toks == pred_toks)
    if num_same == 0:
        return 0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def get_requery_score(prediction: str, gt: str) -> dict:
    """req_score.py — smoothed BLEU-1 + rouge-l F, averaged."""
    from nltk.translate.bleu_score import SmoothingFunction, sentence_bleu
    from rouge import Rouge

    smoothing = SmoothingFunction().method1
    bleu = sentence_bleu([gt.split()], prediction.split(),
                         weights=(1, 0, 0, 0),
                         smoothing_function=smoothing)
    rouge_l = Rouge().get_scores(prediction, gt)[0]["rouge-l"]["f"]
    return {"bleu": bleu, "rouge_l": rouge_l,
            "score": (bleu + rouge_l) / 2}


def postprocess_rerank(rerank: str, rerank_num: int):
    """utils/utils.py postprocess_rerank — "<Website k>" extraction with
    the reference's fallback-to-all-indices behavior."""
    matches = re.findall(r"<Website (\d+)>", rerank)
    output_index = [int(x) - 1 for x in matches]
    if len(output_index) > rerank_num:
        return output_index[:rerank_num], False
    if len(output_index) < rerank_num:
        if len(output_index) == 0:
            output_index = list(range(rerank_num))
        return output_index, False
    return output_index, True


def get_result_summary(records: List[dict], key: str) -> Dict[str, float]:
    """score/result_summary.py — total + per-area + per-subfield
    averages, flattened to metric keys."""
    out = {key: (sum(r[key] for r in records) / len(records)
                 if records else 0.0)}
    for group_field in ("area", "subfield"):
        groups: Dict[str, list] = {}
        for r in records:
            g = r.get(group_field)
            if g is not None:
                groups.setdefault(g, []).append(r[key])
        for g, vals in sorted(groups.items()):
            out[f"{key}_{group_field}_{g}"] = sum(vals) / len(vals)
    return out


# --- prompt assembly ----------------------------------------------------------

def get_website_information(result_brief: List[dict]):
    """utils/prompt_utils.py:12-22."""
    website_information, input_image_list = [], []
    for idx, inst in enumerate(result_brief):
        template = (f"Website {idx + 1} Title: {inst['title']};\n"
                    f"Website {idx + 1} snippet: {inst['snippet']};\n"
                    f"Website {idx + 1} Screenshot: {DEFAULT_IMAGE_TOKEN}")
        website_information.append(template)
        input_image_list.append(inst["screenshot_path"])
    return "\n\n".join(website_information), input_image_list


def get_rerank_incontext_example(rerank_num: int) -> str:
    """utils/prompt_utils.py:25-27."""
    return ",".join(f"<Website {i}>" for i in range(rerank_num))


def crop_and_split(image, slice_height: int = 512, max_slices: int = 10):
    """utils/image_utils.py:114-141 — split a fullpage screenshot into
    <=max_slices horizontal slices of slice_height (PIL Images in, PIL
    Images out; the reference round-trips through files)."""
    width, height = image.size
    num_slices = min(max_slices, (height + slice_height - 1)
                     // slice_height)
    return [image.crop((0, i * slice_height, width,
                        min((i + 1) * slice_height, height)))
            for i in range(num_slices)]


def get_full_website_information(result_full: List[dict]):
    """utils/prompt_utils.py:30-66 — single fullpage: title/snippet/
    content text + the screenshot sliced into <=10 images."""
    inst = result_full[0]
    template = (f"Website Title: {inst['title']};\n"
                f" Website Snippet: {inst['snippet']};\n"
                f"Website Content: {inst['content']};\n")
    screenshot = inst.get("fullpage_screenshot")
    slices = []
    if screenshot is not None:
        slices = crop_and_split(screenshot,
                                FULLPAGE_SPLIT_DICT["slice_height"],
                                FULLPAGE_SPLIT_DICT["max_slices"])
    template += (f"Website Screenshot: "
                 f"{DEFAULT_IMAGE_TOKEN * len(slices)};\n")
    return template, slices


# --- live-web backend (end2end only) --------------------------------------------

class SearchBackend:
    """The live pieces of the end2end loop (utils/utils.py:59-230):
    DuckDuckGo brief results + playwright screenshots, fullpage fetch,
    and BGE-M3 content retrieval. Offline default raises; inject a
    subclass (tests use a fake) or deploy with egress."""

    def brief_search(self, query: str, max_result_num: int) -> Optional[List[dict]]:
        raise RuntimeError(
            "mmsearch_end2end needs a live SearchBackend (DuckDuckGo + "
            "page screenshots, reference utils/utils.py:59-160); this "
            "run has no egress. mmsearch_rerank and "
            "mmsearch_summarization run fully offline.")

    def full_search(self, urls: List[str]) -> List[dict]:
        raise RuntimeError("live SearchBackend required (see brief_search)")

    def retrieve_content(self, requery: str, content: str) -> str:
        """retrieve_content/retriever.py needs BAAI/bge-m3; the offline
        stand-in keeps the head of the content (documented)."""
        return content[:4000]


def run_end2end(doc: dict, generate: Callable[[str, list], str],
                search: SearchBackend) -> List[Optional[str]]:
    """The reference's 3-round protocol (lmms_eval_utils.py:40-166):
    returns [requery, rerank, answer]."""
    query_has_image = doc.get("query_image") is not None
    tmpl = IMAGE_QUERY_DICT if query_has_image else TEXT_QUERY_DICT
    query = doc["query"]

    # round 1: requery
    if not query_has_image:
        text_query = tmpl["stage1"].format(question=query)
        visuals: list = []
    else:
        text_query = tmpl["stage1"].format(
            question=DEFAULT_IMAGE_TOKEN + query,
            image_search_result=DEFAULT_IMAGE_TOKEN)
        visuals = [doc["query_image"], doc["image_search_result"]]
    requery = generate(text_query, visuals)

    # round 2: search + rerank
    result_brief = search.brief_search(requery, BRIEF_RESULT_NUM)
    if result_brief is None:
        return [requery, None, None]
    website_information, image_list = get_website_information(result_brief)
    if not query_has_image:
        text_query = tmpl["stage2"].format(
            brief_result_num=BRIEF_RESULT_NUM, rerank_num=FULLPAGE_NUM,
            question=query, website_information=website_information,
            incontext_example=get_rerank_incontext_example(FULLPAGE_NUM))
        visuals = list(image_list)
    else:
        text_query = tmpl["stage2"].format(
            brief_result_num=BRIEF_RESULT_NUM, rerank_num=FULLPAGE_NUM,
            question=DEFAULT_IMAGE_TOKEN + query,
            image_search_result=DEFAULT_IMAGE_TOKEN,
            website_information=website_information,
            incontext_example=get_rerank_incontext_example(FULLPAGE_NUM))
        visuals = [doc["query_image"], doc["image_search_result"],
                   *image_list]
    rerank = generate(text_query, visuals)

    # round 3: fullpage + summarize
    selected_index, _ = postprocess_rerank(rerank, FULLPAGE_NUM)
    selected = [result_brief[i] for i in selected_index
                if 0 <= i < len(result_brief)]
    result_full = search.full_search([w["url"] for w in selected])
    for full_idx, brief_idx in enumerate(selected_index[:len(result_full)]):
        result_full[full_idx]["title"] = result_brief[brief_idx]["title"]
        result_full[full_idx]["snippet"] = result_brief[brief_idx]["snippet"]
    for inst_full in result_full:
        content = inst_full.get("content") or ""
        if content.strip():
            inst_full["content"] = search.retrieve_content(requery,
                                                           content)
        else:
            inst_full["content"] = ""
    website_full_information, image_list = \
        get_full_website_information(result_full)
    if not query_has_image:
        text_query = tmpl["stage3"].format(
            rerank_num=FULLPAGE_NUM,
            website_information=website_full_information, question=query)
        visuals = list(image_list)
    else:
        text_query = tmpl["stage3"].format(
            rerank_num=FULLPAGE_NUM,
            website_information=website_full_information,
            image_search_result=DEFAULT_IMAGE_TOKEN,
            question=DEFAULT_IMAGE_TOKEN + query)
        visuals = [*image_list, doc["image_search_result"],
                   doc["query_image"]]
    answer = generate(text_query, visuals)
    return [requery, rerank, answer]


# --- tasks --------------------------------------------------------------------

def doc_to_text_end2end(doc) -> str:
    """Round-1 requery prompt (lmms_eval_utils.py:63-71; later rounds
    need the live loop via run_end2end)."""
    if doc.get("query_image") is None:
        return TEXT_QUERY_DICT["stage1"].format(question=doc["query"])
    return IMAGE_QUERY_DICT["stage1"].format(
        question=DEFAULT_IMAGE_TOKEN + doc["query"],
        image_search_result=DEFAULT_IMAGE_TOKEN)


def doc_to_visual_end2end(doc, data_root: str = ""):
    """lmms_eval_utils.py:164-167."""
    if doc.get("query_image") is None:
        return []
    return [doc["query_image"], doc["image_search_result"]]


def process_results_end2end(doc, response) -> dict:
    """lmms_eval_utils.py:278-295 — response is the [requery, rerank,
    answer] round list from run_end2end, or the bare stage-1 requery
    string from a single-round run."""
    if isinstance(response, str):
        round_res: List[Optional[str]] = [response.strip(), None, None]
    else:
        round_res = list(response)
    return {"sample_id": doc["sample_id"], "query": doc["query"],
            "area": doc.get("area"), "subfield": doc.get("subfield"),
            "gt_answer": doc["gt_answer"],
            "gt_requery": doc.get("gt_requery"),
            "alternative_gt_answers":
                doc.get("alternative_gt_answers") or [],
            "requery_prediction": round_res[0],
            "answer_prediction": round_res[2]}


def aggregate_end2end(records: List[dict]) -> Dict[str, float]:
    """lmms_eval_utils.py:339-390 — max-over-alternatives QA F1 (only
    for docs whose answer round ran) + requery score."""
    answered = []
    for r in records:
        if r["answer_prediction"] is None:
            continue
        f1 = get_f1_score(r["answer_prediction"], r["gt_answer"])
        for alt in r["alternative_gt_answers"]:
            f1 = max(f1, get_f1_score(r["answer_prediction"], alt))
        answered.append(dict(r, f1_score=f1))
    out = {}
    out.update({f"end2end_{k}": v for k, v in
                get_result_summary(answered, "f1_score").items()})
    requeried = [dict(r, req_score=get_requery_score(
        r["requery_prediction"], r["gt_requery"])["score"])
        for r in records
        if r["requery_prediction"] and r.get("gt_requery")]
    out.update({f"requery_{k}": v for k, v in
                get_result_summary(requeried, "req_score").items()})
    return {"end2end_f1_score": out.pop("end2end_f1_score", 0.0),
            "requery_score": out.pop("requery_req_score", 0.0), **out}


def doc_to_text_rerank(doc) -> str:
    """lmms_eval_utils.py:184-210."""
    query_has_image = doc.get("query_image") is not None
    tmpl = IMAGE_QUERY_DICT if query_has_image else TEXT_QUERY_DICT
    result_brief = [dict(**doc[f"website{i}_info"],
                         screenshot_path=doc[f"website{i}_head_screenshot"])
                    for i in range(BRIEF_RESULT_NUM)]
    website_information, _ = get_website_information(result_brief)
    if not query_has_image:
        return tmpl["stage2"].format(
            brief_result_num=BRIEF_RESULT_NUM, rerank_num=FULLPAGE_NUM,
            question=doc["query"],
            website_information=website_information,
            incontext_example=get_rerank_incontext_example(FULLPAGE_NUM))
    return tmpl["stage2"].format(
        brief_result_num=BRIEF_RESULT_NUM, rerank_num=FULLPAGE_NUM,
        question=DEFAULT_IMAGE_TOKEN + doc["query"],
        image_search_result=DEFAULT_IMAGE_TOKEN,
        website_information=website_information,
        incontext_example=get_rerank_incontext_example(FULLPAGE_NUM))


def doc_to_visual_rerank(doc, data_root: str = ""):
    """lmms_eval_utils.py:170-181."""
    image_list = []
    if doc.get("query_image") is not None:
        image_list += [doc["query_image"], doc["image_search_result"]]
    image_list += [doc[f"website{i}_head_screenshot"]
                   for i in range(BRIEF_RESULT_NUM)]
    return image_list


def process_results_rerank(doc, response: str) -> dict:
    """lmms_eval_utils.py:298-315."""
    return {"sample_id": doc["sample_id"], "query": doc["query"],
            "area": doc.get("area"), "subfield": doc.get("subfield"),
            "gt_answer": doc["gt_answer"],
            "rerank_prediction": response.strip(),
            "valid": doc["valid"], "not_sure": doc["not_sure"],
            "invalid": doc["invalid"]}


def aggregate_rerank(records: List[dict]) -> Dict[str, float]:
    """lmms_eval_utils.py:394-430."""
    scored = []
    for r in records:
        selected_index, valid = postprocess_rerank(
            r["rerank_prediction"], FULLPAGE_NUM)
        selected = selected_index[0]
        if not valid:
            score = 0.0
        elif selected in r["valid"]:
            score = 1.0
        elif selected in r["not_sure"]:
            score = 0.5
        else:
            score = 0.0
        scored.append(dict(r, rer_score=score))
    out = get_result_summary(scored, "rer_score")
    return {"rek_score": out.pop("rer_score"), **out}


def doc_to_text_summarization(doc) -> str:
    """lmms_eval_utils.py:243-275."""
    query_has_image = doc.get("query_image") is not None
    tmpl = IMAGE_QUERY_DICT if query_has_image else TEXT_QUERY_DICT
    result_full = [{"title": doc["website_title"],
                    "snippet": doc["website_snippet"],
                    "content": doc["website_retrieved_content"],
                    "fullpage_screenshot":
                        doc.get("website_fullpage_screenshot")}]
    website_full_information, _ = \
        get_full_website_information(result_full)
    if not query_has_image:
        return tmpl["stage3"].format(
            rerank_num=FULLPAGE_NUM,
            website_information=website_full_information,
            question=doc["query"])
    return tmpl["stage3"].format(
        rerank_num=FULLPAGE_NUM,
        website_information=website_full_information,
        image_search_result=DEFAULT_IMAGE_TOKEN,
        question=DEFAULT_IMAGE_TOKEN + doc["query"])


def doc_to_visual_summarization(doc, data_root: str = ""):
    """lmms_eval_utils.py:213-240."""
    result_full = [{"title": doc["website_title"],
                    "snippet": doc["website_snippet"],
                    "content": doc["website_retrieved_content"],
                    "fullpage_screenshot":
                        doc.get("website_fullpage_screenshot")}]
    _, slices = get_full_website_information(result_full)
    if doc.get("query_image") is None:
        return list(slices)
    return [*slices, doc["image_search_result"], doc["query_image"]]


def process_results_summarization(doc, response: str) -> dict:
    """lmms_eval_utils.py:318-336."""
    return {"sample_id": doc["sample_id"], "query": doc["query"],
            "area": doc.get("area"), "subfield": doc.get("subfield"),
            "gt_answer": doc["gt_answer"],
            "alternative_gt_answers":
                doc.get("alternative_gt_answers") or [],
            "answer_prediction": response.strip()}


def aggregate_summarization(records: List[dict]) -> Dict[str, float]:
    """lmms_eval_utils.py:339-357 applied to the summarization split."""
    scored = []
    for r in records:
        f1 = get_f1_score(r["answer_prediction"], r["gt_answer"])
        for alt in r["alternative_gt_answers"]:
            f1 = max(f1, get_f1_score(r["answer_prediction"], alt))
        scored.append(dict(r, f1_score=f1))
    out = get_result_summary(scored, "f1_score")
    return {"summarization_f1_score": out.pop("f1_score"), **out}


def _make_load(split: str):
    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("CaraJ/MMSearch", data_root, split_,
                                   subset=split)
    return load_docs


register_task(Task(
    name="mmsearch_end2end",
    doc_to_visual=doc_to_visual_end2end,
    doc_to_text=doc_to_text_end2end,
    doc_to_target=lambda doc: doc.get("gt_answer", ""),
    process_results=process_results_end2end,
    aggregate=aggregate_end2end,
    primary_metric="end2end_f1_score",
    load_docs=_make_load("end2end"),
    doc_id_key="sample_id",
    output_type="generate_until_multi_round",
    generation_kwargs={"max_new_tokens": 512, "temperature": 0,
                       "top_p": 0, "do_sample": False,
                       "until": ["ASSISTANT:"]},
))

register_task(Task(
    name="mmsearch_rerank",
    doc_to_visual=doc_to_visual_rerank,
    doc_to_text=doc_to_text_rerank,
    doc_to_target=lambda doc: str(doc.get("valid", "")),
    process_results=process_results_rerank,
    aggregate=aggregate_rerank,
    primary_metric="rek_score",
    load_docs=_make_load("rerank"),
    doc_id_key="sample_id",
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                       "top_p": 0, "do_sample": False,
                       "until": ["ASSISTANT:"]},
))

register_task(Task(
    name="mmsearch_summarization",
    doc_to_visual=doc_to_visual_summarization,
    doc_to_text=doc_to_text_summarization,
    doc_to_target=lambda doc: doc.get("gt_answer", ""),
    process_results=process_results_summarization,
    aggregate=aggregate_summarization,
    primary_metric="summarization_f1_score",
    load_docs=_make_load("summarization"),
    doc_id_key="sample_id",
    generation_kwargs={"max_new_tokens": 512, "temperature": 0,
                       "top_p": 0, "do_sample": False,
                       "until": ["ASSISTANT:"]},
))

register_group("mmsearch", ["mmsearch_end2end", "mmsearch_rerank",
                            "mmsearch_summarization"])
