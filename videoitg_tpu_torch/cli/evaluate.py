"""Benchmark evaluation CLI on the PyTorch port (lmms-eval replacement).

Counterpart of videoitg_tpu/cli/evaluate.py, run as
`python -m videoitg_tpu_torch.cli.evaluate`. Stage A of the two-stage
pipeline (reference scripts/eval_lmms_eval/*.sh) writes per-doc frame
selections:

  python -m videoitg_tpu_torch.cli.evaluate --model videoitg \\
      --model_args pretrained=/ckpts/VideoITG-8B,num_frames=512,target_fps=1 \\
      --tasks videomme --data_root /data/videomme --output_path ./out

Stage B (a downstream Video-LLM reading out/videomme/results.jsonl) runs on
the JAX package's adapters until they are ported (ROADMAP queue 1, items 5b
and 5c); their names are refused here.

The run is on the card, or it fails; --cpu runs it on the CPU.
--rank/--world_size shard docs across separately-launched processes/hosts
(same round-robin as the reference); rank 0 merges and aggregates through
the shared output directory. Collectives across processes (one
torch.distributed group) are ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videoitg-torch-eval", description=__doc__)
    p.add_argument("--model", required=True, help="adapter name (videoitg, hf-video-llm, echo-answer)")
    p.add_argument("--model_args", default="", help="comma k=v ctor args")
    p.add_argument("--tasks", required=True, help="comma-separated task names")
    p.add_argument("--data_root", default="", help="local benchmark data dir")
    p.add_argument("--split", default=None)
    p.add_argument("--docs_json", default=None,
                   help="explicit docs file (bypasses task loader)")
    p.add_argument("--output_path", default="./eval_out")
    p.add_argument("--limit", type=float, default=None,
                   help="int = first N docs; float in (0,1) = fraction "
                        "(reference --limit)")
    p.add_argument("--predict_only", action="store_true",
                   help="log responses without computing metrics "
                        "(reference --predict_only)")
    p.add_argument("--rank", type=int, default=None,
                   help="doc shard id (default: the torch.distributed rank, else 0)")
    p.add_argument("--world_size", type=int, default=None,
                   help="total shards (default: the torch.distributed world size, else 1)")
    p.add_argument("--log_samples", action="store_true")
    p.add_argument("--use_cache", default=None, metavar="PATH",
                   help="sqlite response cache; reruns skip cached docs "
                        "(reference --use_cache / CachingLMM)")
    p.add_argument("--cache_requests", default=None, metavar="DIR",
                   help="cache loaded task docs as JSON keyed by "
                        "(task, split, data_root); reruns skip the dataset "
                        "load (reference --cache_requests / caching/cache.py "
                        "dill request cache)")
    p.add_argument("--seed", type=int, default=1234,
                   help="recorded into report metadata (reference --seed)")
    p.add_argument("--num_fewshot", type=int, default=None,
                   help="labeled examples prepended per question "
                        "(reference --num_fewshot). Default: the task's "
                        "own num_fewshot (gsm8k/mmlu_pro ship 5-shot, "
                        "video tasks 0-shot); pass 0 to force zero-shot")
    p.add_argument("--fewshot_sampler", default=None,
                   help="'default' (random) or 'first_n' (reference "
                        "api/samplers.py registry). Default: the task's "
                        "fewshot_config sampler, else 'default'")
    p.add_argument("--report_to", default="jsonl",
                   help="'jsonl' or 'jsonl,wandb' — eval-side W&B sink "
                        "(reference WandbLogger, logging_utils.py:70)")
    p.add_argument("--run_name", default=None)
    p.add_argument("--check_integrity", action="store_true",
                   help="validate the requested tasks' registry entries and "
                        "exit (the reference flag routes to a missing file "
                        "and crashes; this one works)")
    p.add_argument("--hub_repo", default=None,
                   help="push aggregated results + sample logs to a dataset "
                        "repo and regenerate its metadata card (reference "
                        "EvaluationTracker push-to-hub). 'local:DIR' or a "
                        "directory path uses that dir as the repo (air-"
                        "gapped dry run); anything else is an HF dataset id")
    p.add_argument("--hub_model_name", default=None,
                   help="model name used in repo paths (default: --model "
                        "plus the pretrained= arg when present)")
    p.add_argument("--judge", default=None, metavar="SPEC",
                   help="LLM judge for judge-scored tasks: exact-match "
                        "(offline default), http:<model>, hf:<path>, "
                        "static:<text> (eval/judge.py)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU; without it the run is on the card or fails")
    p.add_argument("--allow_download", action="store_true",
                   help="authorize media acquisition for tasks with a hub "
                        "MediaSpec: snapshot-download the dataset repo and "
                        "extract its video zips/tars into $HF_HOME/"
                        "<cache_dir> (reference api/task.py:876-1010 does "
                        "this implicitly at task init; here it is opt-in)")
    p.add_argument("--force_unzip", action="store_true",
                   help="re-extract archives even if the media cache is "
                        "already populated (reference force_unzip)")
    return p


def _set_data_root(adapter, root: str) -> None:
    """Point the (possibly cache-wrapped) adapter at a per-task media root."""
    inner = adapter
    while not hasattr(inner, "data_root") and hasattr(inner, "inner"):
        inner = inner.inner
    if hasattr(inner, "data_root"):
        inner.data_root = root


def _load_docs_cached(task, data_root: str, split, cache_dir):
    """task.load_docs with the --cache_requests JSON cache (keyed by
    task/split/data_root — reference --cache_requests / caching/cache.py).
    Returns (docs, from_cache). Shared by the eval-split and
    fewshot-split loads so both hit the same cache."""
    cache_file = None
    if cache_dir:
        import hashlib

        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha1(
            f"{task.name}|{split}|{data_root}".encode()).hexdigest()[:16]
        cache_file = os.path.join(cache_dir,
                                  f"docs.{task.name}.{key}.json")
    if cache_file and os.path.exists(cache_file):
        with open(cache_file) as f:
            return json.load(f), True
    docs = (task.load_docs(data_root, split)
            if split else task.load_docs(data_root))
    if cache_file:
        with open(cache_file, "w") as f:
            json.dump(docs, f, default=str)
    return docs, False


def _engine(adapter):
    """The SelectionEngine behind a (possibly cache-wrapped) adapter."""
    return (getattr(adapter, "engine", None)
            or getattr(getattr(adapter, "inner", None), "engine", None))


def _backend(adapter):
    """The device type the adapter's engine runs on, for the run metadata."""
    engine = _engine(adapter)
    return engine.device.type if engine is not None else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from videoitg_tpu_torch.eval.api import (
        expand_task_names, get_adapter, get_task, parse_model_args,
    )

    if args.judge:
        from videoitg_tpu_torch.eval.judge import set_default_judge

        set_default_judge(args.judge)

    if args.check_integrity:
        from videoitg_tpu_torch.eval.api import check_registry_integrity

        problems = check_registry_integrity(
            [t.strip() for t in args.tasks.split(",")])
        if problems:
            for pr in problems:
                print(f"INTEGRITY: {pr}", file=sys.stderr)
            return 1
        print("task integrity OK")
        return 0
    from videoitg_tpu_torch.eval.harness import (
        ResultsWriter, evaluate_task, make_table, merge_and_aggregate,
        run_metadata, save_report, wait_for_ranks,
    )

    # Multihost default: each torch.distributed rank evaluates its doc shard
    # (the accelerate-DDP equivalent, SURVEY §2.7).
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if args.rank is None:
        args.rank = dist.get_rank() if grouped else 0
    if args.world_size is None:
        args.world_size = dist.get_world_size() if grouped else 1
    # One torch.distributed group spanning the ranks would merge through a
    # collective (the JAX CLI's jax.distributed path): not ported yet.
    if args.world_size > 1 and grouped and dist.get_world_size() == args.world_size:
        print("error: the collective merge of a torch.distributed group is not ported "
              "to PyTorch yet (ROADMAP queue 1, item 8); launch the ranks separately "
              "with --rank / --world_size and a shared --output_path", file=sys.stderr)
        return 2

    model_kwargs = parse_model_args(args.model_args)
    model_kwargs.setdefault("data_root", args.data_root)
    if args.cpu:
        model_kwargs["device"] = "cpu"
    else:
        from videoitg_tpu_torch.cli._model_loading import resolve_device

        resolve_device(False, "videoitg-torch-eval", "--cpu")  # no card: an error
    adapter_base_root = model_kwargs["data_root"]
    try:
        adapter_cls = get_adapter(args.model)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    adapter = adapter_cls(**model_kwargs)
    if args.use_cache:
        from videoitg_tpu_torch.eval.cache import CachingAdapter

        adapter = CachingAdapter(adapter, args.use_cache,
                                 model_tag=f"{args.model}|{args.model_args}")

    reports = []
    task_names = expand_task_names([t.strip() for t in args.tasks.split(",")])
    for task_name in task_names:
        task = get_task(task_name)
        # Per-task media acquisition (opt-in via --allow_download; an
        # explicit --data_root always wins; see eval/acquire.py).
        data_root = args.data_root
        if task.media is not None and not task.media.from_youtube:
            from videoitg_tpu_torch.eval.acquire import resolve_task_media

            data_root = resolve_task_media(
                task, args.data_root, allow_download=args.allow_download,
                force_unzip=args.force_unzip)
        if args.docs_json:
            with open(args.docs_json) as f:
                docs = json.load(f)
        else:
            if task.load_docs is None:
                print(f"error: task {task_name} has no loader; pass --docs_json",
                      file=sys.stderr)
                return 2
            docs, from_cache = _load_docs_cached(
                task, data_root, args.split, args.cache_requests)
            if from_cache:
                print(f"[eval] loaded {len(docs)} docs from request cache")

        if (task.media is not None and task.media.from_youtube
                and not args.data_root):
            # YouTube sentinel path: download per-doc videos (if authorized),
            # then shrink the doc list to ids whose video landed
            # (reference api/task.py:920-931).
            from videoitg_tpu_torch.eval.acquire import acquire_youtube

            data_root, docs = acquire_youtube(
                task.media, docs, allow_download=args.allow_download)
        # Reset EVERY task: a prior task's media resolution may have
        # pointed the shared adapter at ITS cache dir. Tasks without a
        # resolved root restore the adapter's construction-time root (which
        # may come from model_args data_root, not --data_root).
        _set_data_root(adapter, data_root if data_root != args.data_root
                       else adapter_base_root)

        # Fewshot context prefix (reference --num_fewshot + api/samplers.py
        # + the task yaml's num_fewshot/fewshot_split/fewshot_config).
        # CLI --num_fewshot overrides the task default; exemplars come from
        # task.fewshot_split when configured (gsm8k: train, mmlu_pro:
        # validation), else the eval split itself.
        n_shots = (args.num_fewshot if args.num_fewshot is not None
                   else (task.num_fewshot or 0))
        if n_shots:
            from videoitg_tpu_torch.eval.fewshot import with_fewshot

            fewshot_docs, same_split = docs, True
            if task.fewshot_split and task.fewshot_split != args.split:
                if args.docs_json or task.load_docs is None:
                    # --docs_json bypasses the task loader by contract —
                    # don't reach for the hub behind the user's back;
                    # exemplars come from the provided docs instead.
                    print(f"[eval] {task.name}: --docs_json given; fewshot "
                          f"exemplars drawn from the provided docs, not the "
                          f"'{task.fewshot_split}' split")
                else:
                    # Honors --cache_requests like the eval-split load.
                    # Reference same-split rule: fewshot_split ==
                    # test_split (samplers.py:21-22); a dedicated split is
                    # distinct.
                    fewshot_docs, fs_cached = _load_docs_cached(
                        task, data_root, task.fewshot_split,
                        args.cache_requests)
                    if fs_cached:
                        print(f"[eval] loaded {len(fewshot_docs)} fewshot "
                              "docs from request cache")
                    same_split = False
            task = with_fewshot(task, fewshot_docs, n_shots,
                                sampler=args.fewshot_sampler,
                                seed=args.seed, same_split=same_split)

        out_dir = os.path.join(args.output_path, task.name)
        report = evaluate_task(
            adapter, task, docs, out_dir,
            rank=args.rank, world_size=args.world_size,
            limit=args.limit, log_samples=args.log_samples,
            predict_only=args.predict_only,
        )
        # Multi-rank merge: separately-launched rank fleets meet through
        # shared-FS sentinels polled by rank 0.
        if args.rank == 0:
            if args.world_size > 1:
                # Raises RankTimeoutError (nonzero exit, no report) on
                # stragglers — partial benchmark numbers are never written.
                wait_for_ranks(task, out_dir, args.world_size)
                report = merge_and_aggregate(task, out_dir, args.world_size,
                                             predict_only=args.predict_only)
            ResultsWriter(out_dir, args.rank, args.world_size).merge()
            report.metadata = run_metadata(
                model=args.model, model_args=args.model_args,
                world_size=args.world_size, limit=args.limit, seed=args.seed,
                backend=_backend(adapter),
            )
            save_report(report, out_dir)
        reports.append(report)

    if args.rank == 0:
        from videoitg_tpu_torch.eval.api import GROUP_REGISTRY, group_rollup
        from videoitg_tpu_torch.eval.harness import EvalReport

        requested = [t.strip() for t in args.tasks.split(",")]
        for gname in requested:
            if gname in GROUP_REGISTRY:
                rollup = group_rollup(gname, reports)
                if rollup:
                    reports.append(EvalReport(task=gname, metrics=rollup,
                                              num_docs=sum(r.num_docs for r in reports)))
        print(make_table(reports))
        # Eval-side metrics stream (+ optional W&B), one row per task —
        # the reference's WandbLogger/EvaluationTracker counterpart.
        from videoitg_tpu_torch.utils.metrics_logger import MetricsLogger

        mlog = MetricsLogger(args.output_path, report_to=args.report_to,
                             run_name=args.run_name,
                             config={"model": args.model,
                                     "model_args": args.model_args,
                                     "tasks": args.tasks, "seed": args.seed})
        for i, rep in enumerate(reports):
            mlog.log(i, {f"{rep.task}/{k}": v for k, v in rep.metrics.items()})
        mlog.close()
        if args.hub_repo:
            from videoitg_tpu_torch.eval.tracker import EvaluationTracker

            hub_model = args.hub_model_name or "__".join(
                x for x in (args.model,
                            model_kwargs.get("pretrained") or "") if x)
            tracker = EvaluationTracker(args.hub_repo, hub_model)
            written = tracker.push(reports, args.output_path)
            tracker.recreate_metadata_card()
            print(f"pushed {len(written)} file(s) + metadata card to "
                  f"{args.hub_repo}")
        engine = _engine(adapter)
        if engine is not None and engine.timer.totals:
            print("\nstage timings:")
            print(engine.timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
