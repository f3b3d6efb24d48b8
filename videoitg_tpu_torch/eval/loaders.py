"""Benchmark document loading: local-first, HF hub fallback.

The reference downloads via HF datasets at task-init (api/task.py:866+).
Here local data (a directory containing parquet/json/jsonl exported from
the same datasets) takes priority so air-gapped TPU pods can run evals;
the hub path remains for connected environments.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List


def load_benchmark_docs(hf_dataset_id: str, data_root: str, split: str,
                        subset: str | None = None) -> List[dict]:
    if data_root:
        # Subset-parameterized tasks (e.g. the three tempcompass subtasks)
        # share one --data_root: a data_root/<subset>/ subdirectory
        # disambiguates them; a flat data_root keeps working for tasks
        # without subsets.
        if subset and os.path.isdir(os.path.join(data_root, subset)):
            local = _load_local(os.path.join(data_root, subset), split)
            if local is not None:
                return local
        local = _load_local(data_root, split)
        if local is not None:
            return local
    import datasets  # lazy; requires network for the hub path

    ds = datasets.load_dataset(hf_dataset_id, subset, split=split)
    return [dict(row) for row in ds]


def _load_local(data_root: str, split: str) -> List[dict] | None:
    for pattern in (
        os.path.join(data_root, f"{split}*.json"),
        os.path.join(data_root, f"{split}*.jsonl"),
        os.path.join(data_root, "*.json"),
        os.path.join(data_root, "*.jsonl"),
    ):
        files = sorted(glob.glob(pattern))
        if files:
            docs: List[dict] = []
            for f in files:
                with open(f) as fh:
                    if f.endswith(".jsonl"):
                        docs.extend(json.loads(line) for line in fh if line.strip())
                    else:
                        data = json.load(fh)
                        docs.extend(data if isinstance(data, list) else data.get("data", []))
            return docs
    parquets = sorted(glob.glob(os.path.join(data_root, f"*{split}*.parquet"))) or \
        sorted(glob.glob(os.path.join(data_root, "*.parquet")))
    if parquets:
        import datasets

        ds = datasets.load_dataset("parquet", data_files=parquets, split="train")
        return [dict(row) for row in ds]
    return None
