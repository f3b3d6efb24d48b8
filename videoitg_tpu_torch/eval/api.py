"""Lean evaluation API.

A deliberate reimplementation of the slice of lmms-eval that VideoITG's
pipeline actually uses (reference lmms_eval/: 69.6k LoC; the VideoITG path
touches task configs with doc_to_visual/doc_to_text/process_results/
aggregation, per-rank doc sharding, and generate_until model adapters —
see SURVEY §2.4-2.6). One registry, plain dataclasses, no YAML
indirection: tasks are Python modules registering a Task object.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from videoitg_tpu_torch.eval.acquire import MediaSpec

TASK_REGISTRY: Dict[str, "Task"] = {}
ADAPTER_REGISTRY: Dict[str, Callable[..., "ModelAdapter"]] = {}
# group name -> member task names. A group expands to its members and, when
# every member ran, reports the mean of their primary metrics
# (reference lmms_eval/api/group.py ConfigurableGroup).
GROUP_REGISTRY: Dict[str, List[str]] = {}


@dataclass
class Task:
    """One benchmark task.

    load_docs(data_root, split) -> list of raw doc dicts (HF datasets or a
    local directory); doc_to_visual -> video path; doc_to_text -> question
    prompt; process_results(doc, response) -> per-sample record;
    aggregate(records) -> {metric_name: value}.
    """

    name: str
    doc_to_visual: Callable[[dict], str]
    doc_to_text: Callable[[dict], str]
    process_results: Callable[[dict, str], dict]
    aggregate: Callable[[List[dict]], Dict[str, float]]
    load_docs: Optional[Callable[..., List[dict]]] = None
    doc_id_key: Optional[str] = None  # None -> positional ids
    generation_kwargs: Dict[str, Any] = field(default_factory=dict)
    # Metric used for group rollups; defaults to the first key the
    # aggregator returns.
    primary_metric: Optional[str] = None
    # Request type the harness dispatches on (reference evaluator.py:441-457
    # getattr(lm, reqtype)): "generate_until" (default),
    # "generate_until_multi_round", or "loglikelihood". Loglikelihood tasks
    # also set doc_to_target; process_results then receives an
    # (ll, is_greedy) pair instead of a response string.
    output_type: str = "generate_until"
    doc_to_target: Optional[Callable[[dict], str]] = None
    # Per-model prompt variants (reference lmms_eval_specific_kwargs,
    # videomme.yaml:26-41 + api/task.py:790-797): maps a model/adapter name
    # (or "default") to kwargs for doc_to_text, e.g. {"post_prompt": ...}.
    # Resolution: exact model name, else "default", else {}.
    prompt_overrides: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # Response filter pipeline applied before process_results: a list of
    # (filter_name, kwargs_or_None) components (reference filter_list /
    # build_filter_ensemble; see eval/filters.py).
    filters: List[tuple] = field(default_factory=list)
    # Hub location of this task's video blobs (reference dataset_kwargs:
    # dataset_path + cache_dir [+ From_YouTube], api/task.py:876-1010).
    # Consumed by eval/acquire.py behind --allow_download; None = the task
    # only ever reads local --data_root data.
    media: Optional["MediaSpec"] = None
    # Optional temporal focus hint: doc -> (center, width) in SECONDS, or
    # (center, width, "frame") in frame ids, or None. Frame-consuming
    # adapters restrict uniform sampling to that span (reference
    # breakpoint-mode visuals, moviechat/utils.py:67-79 returning
    # {"video_path", "timestep"} — which the reference's own VideoITG-path
    # wrappers never consume; honoring the window here is deliberate).
    # Stage-A ITG selections, when present, take precedence over the window.
    visual_window: Optional[Callable[[dict], Optional[tuple]]] = None
    # Task-default fewshot configuration (the yaml's num_fewshot /
    # fewshot_split / fewshot_config keys, e.g. gsm8k.yaml:30 num_fewshot 5
    # fewshot_split train; mmlu_pro _default_template_yaml fewshot_config
    # sampler first_n + doc_to_text fewshot_to_text + doc_to_target "").
    # --num_fewshot on the CLI overrides num_fewshot; fewshot_config keys:
    # "sampler" (name), "doc_to_text" / "doc_to_target" (exemplar-rendering
    # overrides; doc_to_target may be a constant string).
    num_fewshot: Optional[int] = None
    fewshot_split: Optional[str] = None
    fewshot_config: Dict[str, Any] = field(default_factory=dict)

    def docs_with_ids(self, docs: Sequence[dict]) -> List[tuple]:
        return [
            (doc[self.doc_id_key] if self.doc_id_key else i, doc)
            for i, doc in enumerate(docs)
        ]

    def resolve_prompt_kwargs(self, model_name: Optional[str]) -> Dict[str, Any]:
        """Per-model doc_to_text kwargs (reference api/task.py:790-797)."""
        if model_name is not None and model_name in self.prompt_overrides:
            return dict(self.prompt_overrides[model_name])
        return dict(self.prompt_overrides.get("default", {}))

    def doc_text(self, doc: dict, data_root: str = "",
                 model_name: Optional[str] = None) -> str:
        """doc_to_text with data_root + per-model overrides applied.

        Unlike the reference (which passes the whole kwargs dict positionally,
        task.py:1282), overrides are matched against the callable's accepted
        keyword parameters so tasks only declare the knobs they honor —
        unknown override keys are an error, not silently dropped.
        """
        kwargs = self.resolve_prompt_kwargs(model_name)
        kwargs.setdefault("data_root", data_root)
        return self.doc_to_text(
            doc, **filter_doc_text_kwargs(self.doc_to_text, kwargs, self.name))


def filter_doc_text_kwargs(fn, kwargs: Dict[str, Any],
                           task_name: str) -> Dict[str, Any]:
    """Keep only the kwargs ``fn`` accepts. Unknown keys other than the
    harness-injected ``data_root`` are an error (unknown prompt_overrides
    must not be silently dropped); shared by Task.doc_text and the fewshot
    wrapper (eval/fewshot.py) so the contract lives in one place."""
    param_names, has_varkw = _accepted_params(fn)
    if has_varkw:
        return kwargs
    unknown = [k for k in kwargs if k not in param_names and k != "data_root"]
    if unknown:
        raise TypeError(
            f"task {task_name}: prompt_overrides keys {unknown} not "
            f"accepted by doc_to_text({', '.join(param_names)})")
    return {k: v for k, v in kwargs.items() if k in param_names}


@functools.lru_cache(maxsize=256)
def _accepted_params(fn) -> tuple:
    """(param_names, has_varkw) of a doc_to_text callable — cached: doc_text
    runs once per doc per eval, and signature inspection is the only
    non-trivial cost on that path."""
    import inspect

    params = inspect.signature(fn).parameters
    has_varkw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
    return tuple(params), has_varkw


VALID_OUTPUT_TYPES = ("generate_until", "generate_until_multi_round",
                      "loglikelihood")


def check_task_integrity(task: Task) -> List[str]:
    """Structural validity of a registered task; returns problem strings
    (empty = OK). The reference's --check_integrity routes to a pytest file
    that was never vendored and would crash (lmms_eval/utils.py:555-572) —
    this is the working counterpart."""
    problems = []
    for field_name in ("doc_to_visual", "doc_to_text", "process_results",
                       "aggregate"):
        if not callable(getattr(task, field_name)):
            problems.append(f"{task.name}: {field_name} is not callable")
    if task.output_type not in VALID_OUTPUT_TYPES:
        problems.append(
            f"{task.name}: unknown output_type {task.output_type!r}")
    if task.output_type == "loglikelihood" and not callable(task.doc_to_target):
        problems.append(
            f"{task.name}: loglikelihood tasks need a callable doc_to_target")
    if task.load_docs is not None and not callable(task.load_docs):
        problems.append(f"{task.name}: load_docs is not callable")
    try:
        agg = task.aggregate([])
        if not isinstance(agg, dict):
            problems.append(f"{task.name}: aggregate([]) returned "
                            f"{type(agg).__name__}, expected dict")
        elif task.primary_metric and task.primary_metric not in agg:
            problems.append(f"{task.name}: primary_metric "
                            f"{task.primary_metric!r} not in aggregate() keys")
    except Exception as e:  # empty-record aggregation must never crash
        problems.append(f"{task.name}: aggregate([]) raised "
                        f"{type(e).__name__}: {e}")
    return problems


def check_registry_integrity(names: Optional[List[str]] = None) -> List[str]:
    """Validate tasks (all registered, or the given names incl. groups) and
    that every group member resolves."""
    import videoitg_tpu_torch.eval.tasks  # noqa: F401

    problems = []
    for gname, members in GROUP_REGISTRY.items():
        for m in members:
            if m not in TASK_REGISTRY:
                problems.append(f"group {gname}: unknown member {m!r}")
    targets = (expand_task_names(names) if names else sorted(TASK_REGISTRY))
    for name in targets:
        if name not in TASK_REGISTRY:
            problems.append(f"unknown task {name!r}")
            continue
        problems.extend(check_task_integrity(TASK_REGISTRY[name]))
    return problems


def register_task(task: Task) -> Task:
    TASK_REGISTRY[task.name] = task
    return task


def get_task(name: str) -> Task:
    import videoitg_tpu_torch.eval.tasks  # noqa: F401  (populates the registry)

    if name not in TASK_REGISTRY:
        raise KeyError(f"unknown task {name!r}; have {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]


def register_group(name: str, members: List[str]) -> None:
    GROUP_REGISTRY[name] = list(members)


def expand_task_names(names: List[str]) -> List[str]:
    """Expand group names into member tasks, preserving order, deduped."""
    import videoitg_tpu_torch.eval.tasks  # noqa: F401

    out: List[str] = []
    for n in names:
        for t in GROUP_REGISTRY.get(n, [n]):
            if t not in out:
                out.append(t)
    return out


def register_adapter(name: str):
    def deco(cls):
        ADAPTER_REGISTRY[name] = cls
        # Registry name doubles as the prompt-override key
        # (Task.resolve_prompt_kwargs), like the reference's model_name
        # selection in api/task.py:790-797.
        cls.model_name = name
        return cls

    return deco


def get_adapter(name: str):
    import videoitg_tpu_torch.eval.adapters  # noqa: F401

    if name not in ADAPTER_REGISTRY:
        raise KeyError(f"unknown model adapter {name!r}; have {sorted(ADAPTER_REGISTRY)}")
    return ADAPTER_REGISTRY[name]


class ModelAdapter:
    """Harness <-> model interface (reference lmms_eval/api/model.py ABC).

    generate_until consumes (doc_id, doc, task) work items and returns one
    response string per item; grounding adapters may additionally write
    selection rows through the provided ResultsWriter.
    """

    # Set by @register_adapter; keys per-model prompt overrides.
    model_name: Optional[str] = None

    def generate_until(self, items: List[tuple], task: Task, writer=None) -> List[str]:
        raise NotImplementedError

    def generate_until_multi_round(self, items: List[tuple], task: Task,
                                   writer=None) -> List[str]:
        """Multi-round chat request type; every reference wrapper on the
        VideoITG path delegates to generate_until (e.g. internvl2.py:403)."""
        return self.generate_until(items, task, writer=writer)

    def loglikelihood(self, items: List[tuple], task: Task,
                      writer=None) -> List[tuple]:
        """(loglikelihood, is_greedy) per item for task.doc_to_target's
        continuation (reference api/model.py:29-60). Optional — only
        adapters that expose token logprobs implement it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support loglikelihood requests")


def shard_items(items: Sequence, rank: int, world_size: int) -> List:
    """Round-robin doc sharding, identical to the reference's
    utils.create_iterator islice semantics (api/task.py:434)."""
    return list(itertools.islice(items, rank, None, world_size))


def parse_model_args(s: Optional[str]) -> Dict[str, Any]:
    """Parse 'k=v,k2=v2' --model_args strings (reference utils.py:117)."""
    out: Dict[str, Any] = {}
    if not s:
        return out
    for part in s.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def group_rollup(group_name: str, reports) -> Optional[Dict[str, float]]:
    """Mean of member tasks' primary metrics, or None if any member missing.

    `reports` is a list of objects with .task and .metrics (EvalReport)."""
    members = GROUP_REGISTRY.get(group_name)
    if not members:
        return None
    by_task = {r.task: r.metrics for r in reports}
    values = []
    for name in members:
        metrics = by_task.get(name)
        if not metrics:
            return None
        task = TASK_REGISTRY.get(name)
        key = (task.primary_metric if task and task.primary_metric
               else next(iter(metrics)))
        if key not in metrics:
            return None
        values.append(metrics[key])
    return {f"{group_name}_mean": sum(values) / len(values)}
