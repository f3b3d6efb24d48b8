"""Pluggable LLM-judge backends for judge-scored tasks.

The reference's open-ended video-QA tasks (activitynetqa, videochatgpt,
moviechat, cvrr, vdc, ...) score predictions by POSTing an OpenAI-style
chat payload to an external API from inside process_results (e.g.
lmms_eval/tasks/activitynetqa/utils.py:93-155). That hard-wires scoring
to network egress and a proprietary model. This rebuild factors the
judge into an interface with interchangeable backends:

* ``http:<model>`` — the reference contract: OpenAI-compatible chat
  completions via requests, retry loop + sleep, temperature 0. Matches
  the reference payloads field-for-field so scores are comparable when
  egress exists.
* ``hf:<path-or-id>`` — a local transformers causal LM running the SAME
  judge prompts offline (chat template + greedy decode). Any
  instruction-tuned checkpoint on disk works; no network needed.
* ``exact-match`` — deterministic heuristic fallback (normalized
  exact/containment match -> {'pred': 'yes'/'no', 'score': 5/0}); NOT
  the reference metric, but keeps judge tasks runnable with zero
  dependencies. Records carry judge_model so provenance is explicit.
* ``static:<text>`` — fixed response; test/plumbing backend.

Select with ``videoitg-eval --judge SPEC`` (or VIDEOITG_JUDGE env);
default is exact-match.
"""

from __future__ import annotations

import os
import re
import string
import time
from collections import Counter
from typing import Dict, List, Optional

Message = Dict[str, str]  # {"role": ..., "content": ...}


def content_text(content) -> str:
    """Flatten OpenAI-style content to its text: plain strings pass
    through; vision-style part lists ([{"type": "text", ...},
    {"type": "image_url", ...}]) keep their text parts (the reference's
    image-attaching judges — llava_wilder/utils.py:57-74,
    wild_vision_bench/utils.py:82-96 — use this shape; HttpJudge posts
    the parts verbatim, text-only judges read just the text)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "\n".join(p.get("text", "") for p in content
                         if isinstance(p, dict) and p.get("type") == "text")
    return str(content)

_OPTION_RE = re.compile(r"\s*([A-Z])\.\s*(.*)")
_BARE_LETTER_RE = re.compile(r"\s*([A-Z])\b")


class Judge:
    """Callable judge: chat messages -> raw response text."""

    name = "judge"

    def __call__(self, messages: List[Message], max_tokens: int = 64) -> str:
        raise NotImplementedError


class StaticJudge(Judge):
    def __init__(self, response: str):
        self.response = response
        self.name = "static"

    def __call__(self, messages, max_tokens: int = 64) -> str:
        return self.response


class ExactMatchJudge(Judge):
    """Deterministic offline stand-in: yes + 5 when the normalized gold
    answer appears in the normalized prediction (or vice versa for
    multi-word golds), else no + 0. Divergence from the reference's GPT
    scores is expected and documented; use http:/hf: for parity runs.

    Schema-aware: like the instruction-following model it replaces, it
    reads the requested reply format out of the prompt — the
    {'pred','score'} dict (activitynetqa/moviechat/videochatgpt/vdc
    style), the cvrr {'pred': 'correct'/'incorrect', 'score', 'reason'}
    dict, the mix_evals freeform "[[0.0..1.0]]" correctness score, and
    the mix_evals multiple-choice "[[letter]]" option extraction."""

    name = "exact-match"

    @staticmethod
    def _norm(s: str) -> str:
        s = s.lower().strip()
        return "".join(c for c in s if c not in string.punctuation).strip()

    # labels marking the gold answer / prediction lines across the
    # reference judge prompt families
    _ANSWER_LABELS = ("correct answer:", "ground truth correct answer:",
                      "golden answer(s):")
    _PRED_LABELS = ("predicted answer", "model's answer:")

    def _mc_extract(self, user: str) -> str:
        """Emulate the mix_evals option extractor (video2text/utils.py:
        300-330): map the model's answer to an option letter."""
        lines = user.splitlines()
        options: List[tuple] = []  # (letter, text)
        answer = ""
        in_options = False
        for line in lines:
            low = line.lower()
            if low.startswith("options:"):
                in_options = True
                options = []  # keep only the final (queried) options block
                continue
            if low.startswith("model's answer:"):
                answer = line.split(":", 1)[1].strip()
                # the mc filter embeds the whole resps LIST repr (reference
                # utils.py:373-375) — unwrap it to the first response
                if answer.startswith("[") and answer.endswith("]"):
                    try:
                        import ast
                        v = ast.literal_eval(answer)
                        if isinstance(v, list) and v:
                            answer = str(v[0])
                    except Exception:
                        pass
                in_options = False
                continue
            if in_options:
                m = _OPTION_RE.match(line)
                if m:
                    options.append((m.group(1), m.group(2).strip()))
                elif line.strip():
                    in_options = False
        letter = options[0][0] if options else "A"
        m = _BARE_LETTER_RE.match(answer)
        valid = {l for l, _ in options}
        if m and (not valid or m.group(1) in valid):
            letter = m.group(1)
        else:
            a = self._norm(answer)
            for l, text in options:
                t = self._norm(text)
                if a and t and (a in t or t in a):
                    letter = l
                    break
        return f"The option chosen by the model: [[{letter}]]"

    def _mmbench_match(self, user: str) -> str:
        """Emulate the MMBench answer-matching judge (mmbench/
        mmbench_evals.py:59-78): pick the option most similar to the
        free-form answer, E when none matches. Containment on normalized
        text; the task's can_infer parses the bare letter reply."""
        tail = user[user.rfind("Options:"):]
        answer = ""
        am = re.search(r"\nAnswer:\s*(.*?)\nYour output:", tail, re.S)
        if am:
            answer = am.group(1)
        options: List[tuple] = []
        for line in tail.splitlines():
            m = re.match(r"\s*([A-D])\.\s*(.*)", line)
            if m:
                options.append((m.group(1), m.group(2).strip()))
        a = self._norm(answer)
        hits = [l for l, text in options
                if a and self._norm(text) and
                (self._norm(text) in a or a in self._norm(text))]
        return hits[0] if len(hits) == 1 else "E"

    def _extraction_prompt(self, user: str) -> str:
        """Emulate the MathVista answer-extraction call (mathvista/
        mathvista_evals.py:115-140 DEMO_PROMPT + create_test_prompt):
        the prompt is demo examples + "{query}\\n\\n{response}\\n\\n
        Extracted answer: ". Deterministic stand-in: read the final
        response paragraph (the hints instruct models to put the answer
        "at the end") and pull, in order, an "Answer: xxx" tail, a
        parenthesised option letter, the last number, else the last
        line. NOT the reference GPT extractor; divergence documented in
        the module docstring."""
        body = user[:user.rfind("Extracted answer:")]
        # drop the demo bank: everything up to its final exemplar answer
        demo_end = body.rfind("Extracted answer:")
        if demo_end != -1:
            body = body[demo_end:].split("\n", 1)[-1]
        tail = body.strip().split("\n\n")[-1].strip()
        m = re.findall(r"Answer:\s*(.+)", tail)
        if m:
            tail = m[-1].strip()
        lm = re.search(r"\(([A-Za-z])\)", tail)
        if lm:
            return lm.group(1).upper()
        listm = re.search(r"\[[^\[\]]*\]", tail)
        if listm:
            return listm.group(0)
        nm = re.findall(r"-?\d+(?:\.\d+)?", tail)
        if nm and not re.fullmatch(r"[A-Za-z]", tail.strip(" .")):
            return nm[-1]
        return tail.splitlines()[-1].strip().rstrip(".") if tail else ""

    def _mathverse_extract(self, user: str) -> str:
        """Emulate the MathVerse extraction call (mathverse/
        mathverse_evals.py:178-188: demos + \"Model response: '{r}'\\n
        Extracted Answer: \"). Same tail heuristic as
        _extraction_prompt, applied to the quoted model response."""
        m = re.findall(r"Model response:\s*'(.*?)'\nExtracted [Aa]nswer:",
                       user, re.S)
        if not m:
            return ""
        tail = m[-1].strip().split("\n\n")[-1].strip()
        am = re.findall(r"Answer:\s*(.+)", tail)
        if am:
            tail = am[-1].strip()
        lm = re.search(r"\(([A-Za-z])\)", tail)
        if lm:
            return lm.group(1).upper()
        nm = re.findall(r"-?\d+(?:\.\d+)?", tail)
        if nm and not re.fullmatch(r"[A-Za-z]", tail.strip(" .")):
            return nm[-1]
        return tail.splitlines()[-1].strip().rstrip(".") if tail else "null"

    def _consistency(self, user: str) -> str:
        """Emulate the MathVerse 0/1 consistency judgement (mathverse/
        mathverse_evals.py:205-221): compare the final [Standard Answer]
        / [Model_answer] pair, normalized containment."""
        gts = re.findall(r"\[Standard Answer\]:\s*(.*)", user)
        preds = re.findall(r"\[Model_answer\] :\s*(.*)", user)
        if not gts or not preds:
            return "0"
        gt, pred = self._norm(gts[-1]), self._norm(preds[-1])
        hit = bool(gt) and (gt == pred or
                            (len(gt) > 1 and (gt in pred or pred in gt)))
        return "1" if hit else "0"

    def _mmvet_rubric(self, user: str) -> str:
        """Emulate the MM-Vet 0.0-1.0 rubric (mmvet/utils.py:38-47 +
        104-136): the query is the last line "question | gt | pred |".
        Deterministic stand-in: the gt splits on <AND> into required
        groups (each group may offer <OR> alternatives); score =
        matched groups / total groups — which reproduces the rubric's
        own worked examples (1-of-2 ANDs = 0.5)."""
        # the query is everything after the rubric's final exemplar
        # ("... | 1.0\n"); predictions may span lines
        query = user.rsplit("| 1.0\n", 1)[-1].rstrip().rstrip("|")
        parts = query.split(" | ")
        if len(parts) < 3:
            return "0.0"
        gt, pred = parts[1], self._norm(" | ".join(parts[2:]))
        groups = [g for g in gt.split("<AND>") if g.strip()]
        if not groups:
            return "0.0"
        hit = 0
        for g in groups:
            alts = [self._norm(a) for a in g.split("<OR>")]
            if any(a and a in pred for a in alts):
                hit += 1
        return f"{hit / len(groups):.1f}"

    def _teacher(self, user: str) -> str:
        """Emulate the HallusionBench teacher judgement (hallusion_bench/
        utils.py:38-60): correct / incorrect / unclear. Deterministic
        stand-in on yes/no polarity (the benchmark is yes/no): matching
        polarity -> correct, opposing -> incorrect, missing -> unclear;
        falls back to normalized containment for non-polar answers."""
        m = re.search(r"Reference answer:\s*(.*?)\nPrediction answer:"
                      r"(.*?)\nOutput:", user, re.S)
        if not m:
            return "unclear"
        ref, pred = m.group(1), m.group(2)

        def polarity(s: str):
            s = s.lower()
            has_yes = re.search(r"\byes\b", s) is not None
            has_no = re.search(r"\b(no|not)\b", s) is not None
            if has_yes == has_no:
                return None
            return has_yes
        rp, pp = polarity(ref), polarity(pred)
        if rp is not None and pp is not None:
            return "correct" if rp == pp else "incorrect"
        if pp is None and rp is not None:
            return "unclear"
        r, p = self._norm(ref), self._norm(pred)
        if r and p and (r in p or p in r):
            return "correct"
        return "incorrect"

    def _rating(self, user: str) -> str:
        """Emulate the Vibe-Eval 1-5 rating (vibe_eval/utils.py:39-55):
        deterministic token-F1 between [Assistant Response] and
        [Ground Truth Response], binned to 1-5."""
        m = re.search(r"\[Assistant Response\]\n(.*?)\n\n\[Ground Truth "
                      r"Response\]\n(.*?)\n\n\[System\]", user, re.S)
        if not m:
            return "Explanation: unparseable\nRating: 1"
        t1 = self._norm(m.group(1)).split()
        t2 = self._norm(m.group(2)).split()
        common = Counter(t1) & Counter(t2)
        overlap = sum(common.values())
        denom = len(t1) + len(t2)
        f1 = 2 * overlap / denom if denom else 0.0
        rating = 1 + round(4 * f1)
        return f"Explanation: token-overlap stand-in\nRating: {rating}"

    def _caption_qa(self, user: str) -> str:
        """Emulate the vdc caption-QA generation step (vdc/utils.py:
        201-225): answer a question from a detailed description. Returns
        the description sentence sharing the most words with the
        question (the whole description when it is one sentence)."""
        m = re.search(r"detailed description:\s*(.*),\s*question:\s*(.*?)"
                      r"(?:DO NOT|$)", user, re.S)
        if not m:
            return ""
        description, question = m.group(1), m.group(2)
        sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+",
                                                 description) if s.strip()]
        if len(sentences) <= 1:
            return description.strip()
        qwords = set(self._norm(question).split())
        return max(sentences,
                   key=lambda s: len(qwords & set(self._norm(s).split())))

    def _pairwise_review(self, user: str) -> str:
        """Emulate the LLaVA-Bench two-score review (llava-in-the-wild/
        utils.py:117-160 + rule.json prompts; llava_wilder the same with
        Assistant 1 pinned to 10): first line "s1 s2". Deterministic
        stand-in: Assistant 1 (the reference answer) scores 10;
        Assistant 2 scores 1-10 by token-F1 overlap with Assistant 1.
        NOT the reference metric — use http:/hf: for parity runs."""
        m = re.search(r"\[(?:Assistant|Answer) 1\]\n(.*?)\n\[End of "
                      r"(?:Assistant|Answer) 1\]", user, re.S)
        n = re.search(r"\[(?:Assistant|Answer) 2\]\n(.*?)\n\[End of "
                      r"(?:Assistant|Answer) 2\]", user, re.S)
        if not (m and n):
            return "-1 -1\nunparseable review request"
        t1 = self._norm(m.group(1)).split()
        t2 = self._norm(n.group(1)).split()
        if not t1 or not t2:
            return "10 1\nempty answer"
        common = Counter(t1) & Counter(t2)
        overlap = sum(common.values())
        p = overlap / len(t2)
        r = overlap / len(t1)
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        return f"10 {max(1, round(10 * f1))}\ntoken-overlap stand-in"

    def _arena_verdict(self, user: str) -> str:
        """Emulate the WildVision pairwise verdict (wild_vision_bench/
        utils.py:50-76): A = the baseline answer, B = the model's.
        Deterministic stand-in on token-F1 between the two answers:
        >=0.6 -> [[A=B]], >=0.3 -> [[A>B]], else [[A>>B]] — offline it
        never declares the model better than the baseline; documented
        as non-comparable."""
        m = re.search(r"<\|The Start of Assistant A's Answer\|>\n(.*?)\n"
                      r"<\|The End of Assistant A's Answer\|>", user, re.S)
        n = re.search(r"<\|The Start of Assistant B's Answer\|>\n(.*?)\n"
                      r"<\|The End of Assistant B's Answer\|>", user, re.S)
        if not (m and n):
            return "My final verdict is tie: [[A=B]]"
        t1 = self._norm(m.group(1)).split()
        t2 = self._norm(n.group(1)).split()
        common = Counter(t1) & Counter(t2)
        overlap = sum(common.values())
        denom = len(t1) + len(t2)
        f1 = 2 * overlap / denom if denom else 0.0
        if f1 >= 0.6:
            return "My final verdict is tie: [[A=B]]"
        if f1 >= 0.3:
            return "My final verdict: [[A>B]]"
        return "My final verdict: [[A>>B]]"

    def __call__(self, messages, max_tokens: int = 64) -> str:
        user = next((content_text(m["content"]) for m in messages
                     if m.get("role") == "user"), "")
        system = next((content_text(m["content"]) for m in messages
                       if m.get("role") == "system"), "")
        if "<|User Prompt|>" in user or ("impartial judge" in system and
                                         "[[A>>B]]" in system):
            return self._arena_verdict(user)
        if "[End of Assistant 1]" in user or "[End of Answer 1]" in user:
            return self._pairwise_review(user)
        if '"[[option letter]]"' in user:
            return self._mc_extract(user)
        if "several options of a single-choice question" in user:
            return self._mmbench_match(user)
        if "detailed description:" in user and "question:" in user:
            return self._caption_qa(user)
        if "extract the answer from the model response" in user:
            return self._extraction_prompt(user)
        if "termed 'Model Response'" in user:
            return self._mathverse_extract(user)
        if "Determine whether these two answers are consistent" in user:
            return self._consistency(user)
        if "to give a correctness score for the prediction" in user:
            return self._mmvet_rubric(user)
        if "Imagine you are an intelligent teacher" in user:
            return self._teacher(user)
        if "Rate whether the assistant response correctly matches" in user:
            return self._rating(user)
        answer = None
        preds = []
        for line in user.splitlines():
            low = line.lower()
            if low.startswith(self._ANSWER_LABELS):
                # few-shot prompts (mix_evals) repeat these labels per
                # example: keep only the final (queried) block
                answer = line.split(":", 1)[1]
                preds = []
            elif low.startswith(self._PRED_LABELS):
                # "predicted answer" also covers the consistency pair's
                # "Predicted Answer to Question N:"
                preds.append(line.split(":", 1)[1])
        scored01 = '"[[score]]"' in user  # mix_evals freeform format
        cvrr = "'correct' or 'incorrect'" in user
        if answer is None or not preds:
            hit = False
        else:
            a = self._norm(answer)

            def match(p):
                return bool(a) and (a in p or (len(a.split()) > 1
                                               and p and p in a))

            hit = all(match(self._norm(p)) for p in preds)
        if scored01:
            return (f"The correctness score: [[{'1.0' if hit else '0.0'}]]")
        if cvrr:
            return ("{'pred': 'correct', 'score': 5, 'reason': 'match'}"
                    if hit else
                    "{'pred': 'incorrect', 'score': 0, 'reason': 'mismatch'}")
        return ("{'pred': 'yes', 'score': 5}" if hit
                else "{'pred': 'no', 'score': 0}")


class HttpJudge(Judge):
    """OpenAI-compatible chat completions over HTTP — the reference's
    exact request shape (activitynetqa/utils.py:118-155: temperature 0,
    retry loop with NUM_SECONDS_TO_SLEEP between attempts)."""

    def __init__(self, model: str, api_url: Optional[str] = None,
                 api_key: Optional[str] = None, retries: int = 5,
                 sleep_s: float = 5.0, timeout_s: float = 60.0):
        self.model = model
        self.api_url = api_url or os.environ.get(
            "OPENAI_API_URL", "https://api.openai.com/v1/chat/completions")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.retries = retries
        self.sleep_s = sleep_s
        self.timeout_s = timeout_s
        self.name = f"http:{model}"

    def __call__(self, messages, max_tokens: int = 64) -> str:
        import requests

        payload = {"model": self.model, "messages": messages,
                   "temperature": 0, "max_tokens": max_tokens}
        headers = {"Authorization": f"Bearer {self.api_key}",
                   "Content-Type": "application/json"}
        for attempt in range(self.retries):
            try:
                r = requests.post(self.api_url, headers=headers,
                                  json=payload, timeout=self.timeout_s)
                r.raise_for_status()
                content = r.json()["choices"][0]["message"]["content"].strip()
                if content:
                    return content
            except Exception:
                if attempt == self.retries - 1:
                    return ""
                time.sleep(self.sleep_s)
        return ""


class HFJudge(Judge):
    """Local transformers causal LM as judge (offline). Greedy decode of
    the chat-templated judge prompt; any instruction-tuned checkpoint
    directory works."""

    def __init__(self, model_path: str, device: str = "cpu"):
        import torch  # noqa: F401
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForCausalLM.from_pretrained(model_path)
        self.model.eval()
        self.name = f"hf:{os.path.basename(os.path.normpath(model_path))}"

    def __call__(self, messages, max_tokens: int = 64) -> str:
        import torch

        # text-only LM: flatten any vision-style part lists to their text
        messages = [{**m, "content": content_text(m["content"])}
                    for m in messages]
        tok = self.tokenizer
        if getattr(tok, "chat_template", None):
            ids = tok.apply_chat_template(
                messages, add_generation_prompt=True, return_tensors="pt")
        else:
            text = "\n\n".join(f"{m['role']}: {m['content']}"
                               for m in messages) + "\nassistant:"
            ids = tok(text, return_tensors="pt").input_ids
        with torch.no_grad():
            out = self.model.generate(
                ids, max_new_tokens=max_tokens, do_sample=False,
                pad_token_id=tok.pad_token_id or tok.eos_token_id)
        return tok.decode(out[0, ids.shape[1]:],
                          skip_special_tokens=True).strip()


def build_judge(spec: str) -> Judge:
    """'exact-match' | 'static:<text>' | 'http:<model>' | 'hf:<path>'."""
    if spec == "exact-match":
        return ExactMatchJudge()
    kind, _, arg = spec.partition(":")
    if kind == "static":
        return StaticJudge(arg)
    if kind == "http" and arg:
        return HttpJudge(arg)
    if kind == "hf" and arg:
        return HFJudge(arg)
    raise ValueError(
        f"unknown judge spec {spec!r}; expected exact-match, "
        "static:<text>, http:<model>, or hf:<path>")


_DEFAULT: Optional[Judge] = None


def set_default_judge(spec_or_judge) -> Judge:
    global _DEFAULT
    _DEFAULT = (spec_or_judge if isinstance(spec_or_judge, Judge)
                else build_judge(spec_or_judge))
    return _DEFAULT


def get_judge() -> Judge:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = build_judge(os.environ.get("VIDEOITG_JUDGE",
                                              "exact-match"))
    return _DEFAULT
