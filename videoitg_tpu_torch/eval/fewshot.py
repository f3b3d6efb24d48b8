"""Fewshot context samplers (reference lmms_eval/api/samplers.py).

The reference registry ships two working strategies — ``default``
(ContextSampler: rnd.sample from the fewshot docs) and ``first_n``
(FirstNSampler: canonical ordered examples, MMLU-style); Balanced/Manual
are unimplemented stubs there (samplers.py:72-85) and are not ported.
Context assembly follows samplers.py:20-50: draw one extra example when
sampling from the eval split itself, drop the doc under evaluation,
render each example as ``doc_to_text + target_delimiter + doc_to_target``
joined (and terminated) by ``fewshot_delimiter``.

Every VideoITG-path task is zero-shot (the reference's video task yamls
set num_fewshot 0 or omit it), so this is harness-generality parity:
``videoitg-eval --num_fewshot N`` prefixes each question with N labeled
examples, exactly as the reference's ``fewshot_context`` does for text
tasks (api/task.py:1086-1156 minus the chat-template arm, which the
adapters here own).
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Optional, Sequence

from videoitg_tpu_torch.eval.api import Task, filter_doc_text_kwargs


def _doc_key(doc: dict) -> str:
    """Content identity of a doc, ignoring harness-added underscore keys
    (the mc-loglikelihood expansion's `_choice`/`_ll_id`,
    eval/mc_loglikelihood.py) so every per-option expansion of one source
    question shares an identity."""
    return json.dumps({k: v for k, v in doc.items()
                       if not str(k).startswith("_")},
                      sort_keys=True, default=str)


class ContextSampler:
    """``default``: uniform random draw (samplers.py:53-57).

    Documented divergence from the reference: the reference threads ONE
    stateful rnd through all docs and builds each context exactly once
    (api/task.py fewshot_context), so a second build for the same doc
    would silently differ. This harness calls doc_text more than once per
    doc (response-cache keys, per-option loglikelihood expansions), so the
    draw is derived per doc — rnd seeded from (sampler seed, doc content)
    — making contexts reproducible, call-count- and order-independent,
    and IDENTICAL across a question's per-option expansions. Exclusion of
    the evaluated doc is by content (underscore-stripped), not object
    identity, so a question can never leak its own gold answer into its
    context via an expanded sibling doc.
    """

    def __init__(self, docs: Sequence[dict], task: Task,
                 rnd: Optional[random.Random] = None,
                 fewshot_indices: Optional[Sequence[int]] = None,
                 target_delimiter: str = " ",
                 fewshot_delimiter: str = "\n\n",
                 same_split: bool = True):
        if rnd is None:
            raise ValueError("must pass rnd to ContextSampler "
                             "(samplers.py:4 contract)")
        # fewshot_config may override how EXEMPLARS render (the yaml's
        # fewshot_config doc_to_text/doc_to_target, applied to the sampler
        # only — mmlu_pro renders exemplars via fewshot_to_text with an
        # empty target). doc_to_target may be a constant string.
        self.ex_doc_to_text = task.fewshot_config.get("doc_to_text",
                                                      task.doc_to_text)
        self.ex_doc_to_target = task.fewshot_config.get("doc_to_target",
                                                        task.doc_to_target)
        if self.ex_doc_to_target is None:
            raise ValueError(
                f"task {task.name}: fewshot needs doc_to_target to label "
                "examples")
        # One base draw fixes the sampler's identity; per-doc rngs derive
        # from it (see class docstring).
        self.base_seed = rnd.random()
        self.task = task
        docs = ([docs[i] for i in fewshot_indices]
                if fewshot_indices else list(docs))
        # Dedupe by content identity (underscore keys stripped): the
        # mc-loglikelihood expansion hands this sampler one doc PER OPTION;
        # without the collapse first_n would draw the same question n
        # times. Content-identical source rows are interchangeable as
        # exemplars anyway (exclusion already treats them as one).
        seen, uniq = set(), []
        for d in docs:
            k = _doc_key(d)
            if k not in seen:
                seen.add(k)
                uniq.append(d)
        self.docs = uniq
        self.target_delimiter = target_delimiter
        self.fewshot_delimiter = fewshot_delimiter
        # Reference: draw num_fewshot+1 when fewshot_split == test_split so
        # the evaluated doc can be dropped without going short
        # (samplers.py:21-29).
        self.same_split = same_split

    def sample(self, n: int, rnd: random.Random) -> list:
        return rnd.sample(self.docs, min(n, len(self.docs)))

    def render_example(self, doc: dict) -> str:
        target = (self.ex_doc_to_target if isinstance(self.ex_doc_to_target,
                                                      str)
                  else self.ex_doc_to_target(doc))
        if isinstance(target, list):
            target = str(target[0])
        return (self.ex_doc_to_text(doc) + self.target_delimiter
                + str(target))

    def get_context(self, doc: dict, num_fewshot: int) -> str:
        key = _doc_key(doc)
        rnd = random.Random(f"{self.base_seed}|{key}")
        n = num_fewshot + 1 if self.same_split else num_fewshot
        selected = [d for d in self.sample(n, rnd)
                    if _doc_key(d) != key][:num_fewshot]
        return (self.fewshot_delimiter.join(
            self.render_example(d) for d in selected)
            + self.fewshot_delimiter)


class FirstNSampler(ContextSampler):
    """``first_n``: the first N docs in order (samplers.py:61-68)."""

    def sample(self, n: int, rnd: random.Random) -> list:
        if n > len(self.docs):
            raise ValueError(
                f"requested {n} fewshot samples but only {len(self.docs)} "
                "available (samplers.py:66 contract)")
        return self.docs[:n]


SAMPLER_REGISTRY = {
    "default": ContextSampler,
    "first_n": FirstNSampler,
}


def get_sampler(name: str):
    try:
        return SAMPLER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown fewshot sampler {name!r}; supported: "
            f"{', '.join(SAMPLER_REGISTRY)}") from None


def with_fewshot(task: Task, fewshot_docs: Sequence[dict], num_fewshot: int,
                 sampler: Optional[str] = None, seed: int = 1234,
                 same_split: bool = True) -> Task:
    """A copy of ``task`` whose doc_to_text prepends a sampled fewshot
    context (the reference's fewshot_context concatenation,
    api/task.py:1146-1153). num_fewshot <= 0 returns the task unchanged.
    sampler=None resolves the task's own fewshot_config sampler (else
    "default"); an explicit name wins."""
    if num_fewshot <= 0:
        return task
    if sampler is None:
        sampler = task.fewshot_config.get("sampler", "default")
    ctx = get_sampler(sampler)(fewshot_docs, task,
                               rnd=random.Random(seed),
                               same_split=same_split)
    orig = task.doc_to_text
    # Reference prompt order is description + exemplars + query
    # (api/task.py fewshot_context: description first). Tasks that bake a
    # corpus header into doc_to_text (mmlu's per-subject line) hoist it
    # via fewshot_config: "description" prepends once, "query_kwargs"
    # overrides the query render (e.g. description="") so the header
    # doesn't repeat per exemplar or before the final question.
    description = task.fewshot_config.get("description", "")
    query_kwargs = task.fewshot_config.get("query_kwargs", {})

    def fewshot_doc_to_text(doc, **kwargs):
        # This wrapper is **kwargs, so Task.doc_text passes everything
        # through; apply the same filtering contract to the original fn.
        kwargs = filter_doc_text_kwargs(orig, {**kwargs, **query_kwargs},
                                        task.name)
        return (description + ctx.get_context(doc, num_fewshot)
                + orig(doc, **kwargs))

    return dataclasses.replace(task, doc_to_text=fewshot_doc_to_text)
