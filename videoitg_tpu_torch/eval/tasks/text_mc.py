"""Text-only multiple-choice suites scored by loglikelihood: HellaSwag,
ARC (easy/challenge), GPQA (zeroshot, 3 subsets), and MMLU (57 subjects
+ 4 category rollups).

Parity: lmms_eval/tasks/hellaswag/{hellaswag.yaml,utils.py},
tasks/arc/{arc_easy,arc_challenge}.yaml, tasks/gpqa/zeroshot/
{_gpqa_zeroshot_yaml,utils.py}, tasks/mmlu/default/
{_default_template_yaml,mmlu_<subject>.yaml}. These exercise the
harness's zero-frame branch (doc_to_visual -> None) and the
loglikelihood request path with real option fan-out: each doc expands
to one request per choice via eval/mc_loglikelihood.make_mc_ll_suite,
reporting acc (raw argmax) and acc_norm (length-normalized — lm-eval's
convention; the upstream yamls register both for hellaswag/arc and acc
for mmlu/gpqa).

Doc preprocessing ports: hellaswag's ctx_a+ctx_b.capitalize() splice
and bracket scrub (utils.py:6-26); gpqa's choice shuffle — the
reference shuffles with the process RNG (zeroshot/utils.py:17-38,
seeded by lm-eval's --seed); here the shuffle is seeded per doc with
crc32(Question) so reruns and rank shards agree without global RNG
state (documented divergence: a different but fixed permutation).
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.mc_loglikelihood import make_mc_ll_suite


def no_visual(doc, data_root: str = ""):
    """Zero-frame branch: text-only docs feed the LM alone (same
    contract as mathverse's text_only split)."""
    return None


def _register_mc(name: str, *, hub: str, subset, split: str,
                 doc_to_text, n_options_of, option_text_of,
                 answer_index_of, qid_of, transform=None,
                 metric_prefix=None, fewshot_split=None,
                 fewshot_sampler=None, fewshot_extra=None):
    expand, doc_to_target, process, aggregate = make_mc_ll_suite(
        qid_of=qid_of,
        n_options_of=n_options_of,
        option_text_of=option_text_of,
        answer_index_of=answer_index_of,
        metric_prefix=metric_prefix or name,
    )

    # Fewshot exemplars render the GOLD choice, matching the reference's
    # multiple_choice arm (samplers.py:36-43:
    # doc_to_choice(doc)[doc_to_target(doc)]) — NOT the per-expansion
    # `_choice` continuation the loglikelihood requests score.
    fewshot_config = {
        "doc_to_target":
            lambda d: option_text_of(d, answer_index_of(d)).strip(),
    }
    if fewshot_sampler:
        fewshot_config["sampler"] = fewshot_sampler
    if fewshot_extra:
        fewshot_config.update(fewshot_extra)

    def load_docs(data_root: str, split_: str = split) -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        docs = load_benchmark_docs(hub, data_root, split_, subset=subset)
        if transform is not None:
            docs = [transform(d) for d in docs]
        # positional row id: stable qid even when the dataset carries no
        # unique key (mmlu/hellaswag rows have none)
        for i, d in enumerate(docs):
            d.setdefault("_row", i)
        return expand(docs)

    register_task(Task(
        name=name,
        doc_to_visual=no_visual,
        doc_to_text=doc_to_text,
        doc_to_target=doc_to_target,
        output_type="loglikelihood",
        process_results=process,
        aggregate=aggregate,
        load_docs=load_docs,
        doc_id_key="_ll_id",
        primary_metric=f"{metric_prefix or name}_acc",
        fewshot_split=fewshot_split,
        fewshot_config=fewshot_config,
    ))


# --- hellaswag ----------------------------------------------------------------

def hellaswag_preprocess(text: str) -> str:
    """hellaswag/utils.py:6-12."""
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub("\\[.*?\\]", "", text)
    text = text.replace("  ", " ")
    return text


def hellaswag_transform(doc: dict) -> dict:
    """hellaswag/utils.py:15-26."""
    ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
    return {
        **doc,
        "query": hellaswag_preprocess(doc["activity_label"] + ": " + ctx),
        "choices": [hellaswag_preprocess(e) for e in doc["endings"]],
        "gold": int(doc["label"]),
    }


_register_mc(
    "hellaswag",
    hub="hellaswag", subset=None, split="validation",
    doc_to_text=lambda doc: doc["query"],
    n_options_of=lambda d: len(d["choices"]),
    option_text_of=lambda d, i: d["choices"][i],
    answer_index_of=lambda d: d["gold"],
    qid_of=lambda d: d["_row"],
    transform=hellaswag_transform,
)


# --- ARC ----------------------------------------------------------------------

def _arc_answer_index(doc) -> int:
    """arc_easy.yaml doc_to_target: choices.label.index(answerKey)."""
    return list(doc["choices"]["label"]).index(doc["answerKey"])


for _name, _subset in (("arc_easy", "ARC-Easy"),
                       ("arc_challenge", "ARC-Challenge")):
    _register_mc(
        _name,
        hub="allenai/ai2_arc", subset=_subset, split="test",
        doc_to_text=lambda doc: f"Question: {doc['question']}\nAnswer:",
        n_options_of=lambda d: len(d["choices"]["text"]),
        option_text_of=lambda d, i: d["choices"]["text"][i],
        answer_index_of=_arc_answer_index,
        qid_of=lambda d: d["id"],
    )

register_group("ai2_arc", ["arc_easy", "arc_challenge"])


# --- GPQA zeroshot --------------------------------------------------------------

def gpqa_preprocess(text) -> str:
    """gpqa/zeroshot/utils.py:7-14."""
    if text is None:
        return " "
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub("\\[.*?\\]", "", text)
    text = text.replace("  ", " ")
    return text


def gpqa_transform(doc: dict) -> dict:
    """gpqa/zeroshot/utils.py:17-38 with a crc32-per-doc shuffle
    (divergence note in the module docstring)."""
    import random

    choices = [
        gpqa_preprocess(doc["Incorrect Answer 1"]),
        gpqa_preprocess(doc["Incorrect Answer 2"]),
        gpqa_preprocess(doc["Incorrect Answer 3"]),
        gpqa_preprocess(doc["Correct Answer"]),
    ]
    rng = random.Random(zlib.crc32(str(doc["Question"]).encode()))
    rng.shuffle(choices)
    correct = choices.index(gpqa_preprocess(doc["Correct Answer"]))
    return {**doc,
            "choice1": choices[0], "choice2": choices[1],
            "choice3": choices[2], "choice4": choices[3],
            "answer_index": correct}


def gpqa_doc_to_text(doc) -> str:
    """_gpqa_zeroshot_yaml doc_to_text."""
    return (f"What is the correct answer to this question:"
            f"{doc['Question']}\nChoices:\n(A) {doc['choice1']}\n"
            f"(B) {doc['choice2']}\n(C) {doc['choice3']}\n"
            f"(D) {doc['choice4']}\nAnswer:")


for _name, _subset in (("gpqa_main_zeroshot", "gpqa_main"),
                       ("gpqa_diamond_zeroshot", "gpqa_diamond"),
                       ("gpqa_extended_zeroshot", "gpqa_extended")):
    _register_mc(
        _name,
        hub="Idavidrein/gpqa", subset=_subset, split="train",
        doc_to_text=gpqa_doc_to_text,
        # doc_to_choice is the LETTER "(A)".."(D)" (yaml), not the text
        n_options_of=lambda d: 4,
        option_text_of=lambda d, i: f"({chr(65 + i)})",
        answer_index_of=lambda d: d["answer_index"],
        qid_of=lambda d: d.get("Record ID", d["_row"]),
        transform=gpqa_transform,
    )

register_group("gpqa", ["gpqa_main_zeroshot", "gpqa_diamond_zeroshot",
                        "gpqa_extended_zeroshot"])


# --- MMLU ----------------------------------------------------------------------

# Subject -> category (extracted from the 57 per-subject yamls' tags).
MMLU_SUBJECTS: Dict[str, str] = {
    "abstract_algebra": "stem", "anatomy": "stem", "astronomy": "stem",
    "business_ethics": "other", "clinical_knowledge": "other",
    "college_biology": "stem", "college_chemistry": "stem",
    "college_computer_science": "stem", "college_mathematics": "stem",
    "college_medicine": "other", "college_physics": "stem",
    "computer_security": "stem", "conceptual_physics": "stem",
    "econometrics": "social_sciences", "electrical_engineering": "stem",
    "elementary_mathematics": "stem", "formal_logic": "humanities",
    "global_facts": "other", "high_school_biology": "stem",
    "high_school_chemistry": "stem",
    "high_school_computer_science": "stem",
    "high_school_european_history": "humanities",
    "high_school_geography": "social_sciences",
    "high_school_government_and_politics": "social_sciences",
    "high_school_macroeconomics": "social_sciences",
    "high_school_mathematics": "stem",
    "high_school_microeconomics": "social_sciences",
    "high_school_physics": "stem",
    "high_school_psychology": "social_sciences",
    "high_school_statistics": "stem",
    "high_school_us_history": "humanities",
    "high_school_world_history": "humanities", "human_aging": "other",
    "human_sexuality": "social_sciences",
    "international_law": "humanities", "jurisprudence": "humanities",
    "logical_fallacies": "humanities", "machine_learning": "stem",
    "management": "other", "marketing": "other",
    "medical_genetics": "other", "miscellaneous": "other",
    "moral_disputes": "humanities", "moral_scenarios": "humanities",
    "nutrition": "other", "philosophy": "humanities",
    "prehistory": "humanities", "professional_accounting": "other",
    "professional_law": "humanities", "professional_medicine": "other",
    "professional_psychology": "social_sciences",
    "public_relations": "social_sciences",
    "security_studies": "social_sciences", "sociology": "social_sciences",
    "us_foreign_policy": "social_sciences", "virology": "other",
    "world_religions": "humanities",
}


def mmlu_description(subject: str) -> str:
    """Per-subject yaml description, e.g. mmlu_abstract_algebra.yaml."""
    return ("The following are multiple choice questions (with answers) "
            f"about {subject.replace('_', ' ')}.\n\n")


def _make_mmlu_doc_to_text(subject: str):
    def doc_to_text(doc, description: str = mmlu_description(subject)):
        """_default_template_yaml doc_to_text with the subject
        description prepended (lm-eval prepends description before the
        [fewshot+] query)."""
        q = doc["question"].strip()
        c = doc["choices"]
        return (f"{description}{q}\nA. {c[0]}\nB. {c[1]}\nC. {c[2]}\n"
                f"D. {c[3]}\nAnswer:")
    return doc_to_text


def _make_bare_mmlu_doc_to_text(subject: str):
    fn = _make_mmlu_doc_to_text(subject)
    return lambda doc: fn(doc, description="")


for _subject in MMLU_SUBJECTS:
    _register_mc(
        f"mmlu_{_subject}",
        hub="hails/mmlu_no_train", subset=_subject, split="test",
        doc_to_text=_make_mmlu_doc_to_text(_subject),
        # doc_to_choice: the LETTERS (template yaml)
        n_options_of=lambda d: 4,
        option_text_of=lambda d, i: "ABCD"[i],
        answer_index_of=lambda d: int(d["answer"]),
        qid_of=lambda d: d["_row"],
        metric_prefix=f"mmlu_{_subject}",
        # _default_template_yaml: fewshot_split dev, sampler first_n
        # (no default num_fewshot — 0-shot unless --num_fewshot is given).
        # The subject header renders ONCE before the exemplars (lm-eval's
        # description-first order), so exemplars and the final query use
        # the bare question format.
        fewshot_split="dev",
        fewshot_sampler="first_n",
        fewshot_extra={
            "description": mmlu_description(_subject),
            "doc_to_text": _make_bare_mmlu_doc_to_text(_subject),
            "query_kwargs": {"description": ""},
        },
    )

for _cat in ("stem", "humanities", "social_sciences", "other"):
    register_group(f"mmlu_{_cat}",
                   [f"mmlu_{s}" for s, c in MMLU_SUBJECTS.items()
                    if c == _cat])
register_group("mmlu", [f"mmlu_{s}" for s in MMLU_SUBJECTS])
