"""Evaluation runner: doc sharding, two-stage orchestration, results IO.

Replaces the reference's evaluator.py/evaluator_utils.py core loop for the
VideoITG pipeline. Differences by design:

* results.jsonl writing: the reference has every rank append to one shared
  file (videoitg.py:317-319 — a documented race, SURVEY §5.2). Here each
  shard writes results.rank{r}.jsonl and a deterministic merge keyed by
  doc_id produces results.jsonl.
* doc sharding uses the same islice(rank, None, world) round-robin, so a
  given (rank, world_size) processes exactly the reference's docs.
* resumability: existing per-rank shard files are consulted and completed
  doc_ids skipped (the reference reprocesses everything).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from videoitg_tpu_torch.eval.api import ModelAdapter, Task, shard_items


class ResultsWriter:
    """Per-rank selection rows + deterministic merge (grounding stage A)."""

    def __init__(self, output_dir: str, rank: int = 0, world_size: int = 1):
        self.output_dir = output_dir
        self.rank = rank
        self.world_size = world_size
        os.makedirs(output_dir, exist_ok=True)
        self.shard_path = os.path.join(output_dir, f"results.rank{rank}.jsonl")
        self._rows: Dict[object, dict] = {}
        if os.path.exists(self.shard_path):
            with open(self.shard_path) as f:
                for line in f:
                    try:
                        row = json.loads(line)
                        self._rows[row["doc_id"]] = row
                    except Exception:
                        pass

    def is_done(self, doc_id) -> bool:
        return doc_id in self._rows

    def get_row(self, doc_id) -> Optional[dict]:
        """Stored selection row for a completed doc (resume path)."""
        return self._rows.get(doc_id)

    def write(self, row: dict) -> None:
        with open(self.shard_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
        self._rows[row["doc_id"]] = row

    def merge(self) -> str:
        """Merge all rank shards into results.jsonl, ordered by doc_id."""
        rows: Dict[object, dict] = {}
        for r in range(self.world_size):
            p = os.path.join(self.output_dir, f"results.rank{r}.jsonl")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        rows[row["doc_id"]] = row
        return write_results_jsonl(rows, self.output_dir)


def write_results_jsonl(rows: Dict[object, dict], output_dir: str) -> str:
    """Write the merged results.jsonl, doc_id-ordered — the ONE place the
    merge contract lives (used by both the shared-FS and collective paths)."""
    merged = os.path.join(output_dir, "results.jsonl")
    with open(merged, "w", encoding="utf-8") as f:
        for k in sorted(rows, key=lambda x: (str(type(x)), x)):
            f.write(json.dumps(rows[k], ensure_ascii=False) + "\n")
    return merged


@dataclass
class EvalReport:
    task: str
    metrics: Dict[str, float]
    num_docs: int
    samples: List[dict] = field(default_factory=list)
    metadata: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"task": self.task, "metrics": self.metrics, "num_docs": self.num_docs}
        if self.metadata:
            out["metadata"] = self.metadata
        return out


def run_metadata(model: str = "", model_args: str = "",
                 world_size: int = 1, limit=None, seed=None,
                 backend: Optional[str] = None) -> Dict[str, object]:
    """Reproducibility record for report.json — the reference attaches git
    hash, seeds, and the full run config to its results dict
    (lmms_eval/evaluator.py:268-292)."""
    import datetime
    import subprocess

    try:
        git_hash = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        git_hash = None
    meta: Dict[str, object] = {
        "model": model,
        "model_args": model_args,
        "world_size": world_size,
        "limit": limit,
        "seed": seed,
        "git_hash": git_hash,
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
    }
    # The device type the run used ("cuda" or "cpu"); by default the card
    # when there is one, as the entry points choose.
    import torch

    meta["torch_version"] = torch.__version__
    meta["backend"] = backend or ("cuda" if torch.cuda.is_available() else "cpu")
    return meta


def evaluate_task(
    adapter: ModelAdapter,
    task: Task,
    docs: Sequence[dict],
    output_dir: str,
    rank: int = 0,
    world_size: int = 1,
    limit: Optional[float] = None,
    log_samples: bool = False,
    predict_only: bool = False,
) -> EvalReport:
    """Run one task: shard docs, generate, score, aggregate.

    With world_size > 1 each process scores its shard and writes per-rank
    artifacts; metric aggregation runs on the merged records (rank 0 merges
    after all ranks finish — on a multihost pod call merge via
    `merge_and_aggregate` once shards are complete).

    limit: int = first N docs; float in (0, 1) = that fraction of docs
    (reference --limit semantics, evaluator_utils.get_sample_size).
    predict_only skips process_results/metrics and only logs responses
    (reference --predict_only)."""
    items = task.docs_with_ids(docs)
    if limit is not None:
        n = int(len(items) * limit) if 0 < limit < 1 else int(limit)
        items = items[:n]
    my_items = shard_items(items, rank, world_size)

    writer = ResultsWriter(output_dir, rank, world_size)
    # Request-type dispatch, reference evaluator.py:441-457
    # (getattr(lm, reqtype)(cloned_reqs)).
    request_fn = getattr(adapter, task.output_type or "generate_until")
    responses = request_fn(my_items, task, writer=writer)

    if task.filters and task.output_type != "loglikelihood":
        # Generic filter pipeline (reference task.apply_filters,
        # evaluator.py:468) — see eval/filters.py.
        from videoitg_tpu_torch.eval.filters import apply_task_filters

        responses = apply_task_filters(
            task, responses, [doc for _id, doc in my_items])

    records = []
    sample_log = []
    for (doc_id, doc), resp in zip(my_items, responses):
        rec = {} if predict_only else task.process_results(doc, resp)
        records.append(rec)
        if log_samples or predict_only:
            sample_log.append({"doc_id": doc_id, "response": resp, **rec})

    # Persist per-rank records so rank-0 (or a later process) can aggregate.
    rec_path = os.path.join(output_dir, f"records.rank{rank}.{task.name}.jsonl")
    with open(rec_path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    if log_samples or predict_only:
        # Per-sample response log (the reference EvaluationTracker's
        # save_results_samples counterpart).
        sample_path = os.path.join(output_dir, f"samples.rank{rank}.{task.name}.jsonl")
        with open(sample_path, "w", encoding="utf-8") as f:
            for s in sample_log:
                f.write(json.dumps(s, ensure_ascii=False, default=str) + "\n")

    # Completion sentinel: rank 0 waits on these before merging (the
    # reference synchronizes with dist.barrier before rank-0 aggregation,
    # evaluator.py:573; on TPU pods the shared filesystem is the channel).
    with open(os.path.join(output_dir, f"done.rank{rank}.{task.name}"), "w") as f:
        f.write(str(len(records)))

    metrics = {} if predict_only else (task.aggregate(records) if records else {})
    return EvalReport(task=task.name, metrics=metrics, num_docs=len(records),
                      samples=sample_log)


class RankTimeoutError(RuntimeError):
    """Raised when rank sentinels never appear — a silently-partial benchmark
    number is worse than a crash, so the caller must NOT merge or write
    report.json (the reference instead hides stragglers behind a 52-week
    NCCL timeout, videoitg.py:154)."""


def wait_for_ranks(task: Task, output_dir: str, world_size: int,
                   timeout_s: float = 86400.0, poll_s: float = 10.0) -> bool:
    """Block until every rank's completion sentinel exists (shared FS).

    Raises RankTimeoutError on timeout; returns True otherwise."""
    import time as _time

    deadline = _time.time() + timeout_s
    while True:
        missing = [r for r in range(world_size)
                   if not os.path.exists(
                       os.path.join(output_dir, f"done.rank{r}.{task.name}"))]
        if not missing:
            return True
        if _time.time() > deadline:
            raise RankTimeoutError(
                f"timed out after {timeout_s}s waiting for ranks {missing} on "
                f"task {task.name}; refusing to aggregate partial results"
            )
        _time.sleep(poll_s)


def collective_merge_and_aggregate(task: Task, output_dir: str, rank: int,
                                   predict_only: bool = False) -> EvalReport:
    """Collective alternative to wait_for_ranks + merge_and_aggregate for
    jax.distributed fleets (no shared filesystem required): every rank
    contributes its records AND its selection rows through one allgather
    (the reference's gather_object + barrier, evaluator.py:553-573); rank 0
    writes the merged results.jsonl. MUST be called by all ranks."""
    from videoitg_tpu_torch.eval import multihost

    my_records: List[dict] = []
    p = os.path.join(output_dir, f"records.rank{rank}.{task.name}.jsonl")
    if os.path.exists(p):
        with open(p) as f:
            my_records = [json.loads(x) for x in f if x.strip()]
    my_rows: List[dict] = []
    shard = os.path.join(output_dir, f"results.rank{rank}.jsonl")
    if os.path.exists(shard):
        with open(shard) as f:
            my_rows = [json.loads(x) for x in f if x.strip()]

    gathered = multihost.gather_objects({"records": my_records, "rows": my_rows})
    records = [r for g in gathered for r in g["records"]]
    if rank == 0:
        rows = {row["doc_id"]: row for g in gathered for row in g["rows"]}
        if rows:
            write_results_jsonl(rows, output_dir)
    metrics = ({} if (predict_only or not records)
               else task.aggregate(records))
    return EvalReport(task=task.name, metrics=metrics, num_docs=len(records))


def merge_and_aggregate(task: Task, output_dir: str, world_size: int,
                        predict_only: bool = False) -> EvalReport:
    """Aggregate the union of all ranks' records (rank-0 step)."""
    records: List[dict] = []
    for r in range(world_size):
        p = os.path.join(output_dir, f"records.rank{r}.{task.name}.jsonl")
        if os.path.exists(p):
            with open(p) as f:
                records.extend(json.loads(x) for x in f if x.strip())
    # predict_only ranks wrote empty records — aggregating would KeyError
    metrics = {} if predict_only else task.aggregate(records)
    return EvalReport(task=task.name, metrics=metrics, num_docs=len(records))


def save_report(report: EvalReport, output_dir: str) -> str:
    path = os.path.join(output_dir, f"report.{report.task}.json")
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2)
    return path


def make_table(reports: Sequence[EvalReport]) -> str:
    lines = [f"{'task':<24} {'metric':<32} {'value':>10}",
             "-" * 68]
    for rep in reports:
        for name, value in rep.metrics.items():
            lines.append(f"{rep.task:<24} {name:<32} {value:>10.4f}")
    return "\n".join(lines)
