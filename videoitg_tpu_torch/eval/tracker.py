"""Results push to a dataset repo + metadata card.

The reference's EvaluationTracker uploads aggregated results and per-sample
logs to a HF-hub dataset repo and regenerates a README metadata card whose
YAML `configs` expose, per model, every dated results file plus a "latest"
split (reference lmms_eval/loggers/evaluation_tracker.py:170-320 save paths,
:324-396 card). This rebuild keeps the same repo layout:

    {model_name_sanitized}/results_{date}.json
    {model_name_sanitized}/samples_{task}_{date}.jsonl

but abstracts the storage backend so the whole flow is dry-runnable with
zero egress: `--hub_repo local:/some/dir` treats a local directory as the
dataset repo (the default backend offline); any other value goes
through huggingface_hub when it is importable and authenticated.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

# HF-safe timestamp (no colons in repo paths), reference uses the same idea
# with datetime.isoformat + sanitization (evaluation_tracker.py:379).
_DATE_FMT = "%Y-%m-%dT%H-%M-%S"
_RESULTS_RE = re.compile(r"^results_(?P<date>[\dT\-]+)\.json$")
_SAMPLES_RE = re.compile(r"^samples_(?P<task>.+)_(?P<date>[\dT\-]+)\.jsonl$")


def sanitize_model_name(name: str) -> str:
    """org/model -> org__model (reference general_utils.sanitize_model_name)."""
    return re.sub(r"[\"<>:/\|\\?\*\[\]]+", "__", name)


class LocalHubAPI:
    """Directory-as-dataset-repo backend (dry-run / air-gapped)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_repo_files(self) -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                out.append(f if rel == "." else os.path.join(rel, f))
        return sorted(out)

    def upload_file(self, local_path: str, path_in_repo: str) -> None:
        dest = os.path.join(self.root, path_in_repo)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(local_path, dest)

    def upload_text(self, text: str, path_in_repo: str) -> None:
        dest = os.path.join(self.root, path_in_repo)
        os.makedirs(os.path.dirname(dest) or self.root, exist_ok=True)
        with open(dest, "w") as f:
            f.write(text)


class HfHubAPI:
    """huggingface_hub dataset-repo backend (needs network + token)."""

    def __init__(self, repo_id: str, token: Optional[str] = None):
        from huggingface_hub import HfApi  # deferred: optional dependency

        self.repo_id = repo_id
        self.api = HfApi(token=token)
        self.api.create_repo(repo_id, repo_type="dataset", exist_ok=True)

    def list_repo_files(self) -> List[str]:
        return sorted(self.api.list_repo_files(
            repo_id=self.repo_id, repo_type="dataset"))

    def upload_file(self, local_path: str, path_in_repo: str) -> None:
        self.api.upload_file(path_or_fileobj=local_path,
                             path_in_repo=path_in_repo,
                             repo_id=self.repo_id, repo_type="dataset")

    def upload_text(self, text: str, path_in_repo: str) -> None:
        self.api.upload_file(path_or_fileobj=text.encode(),
                             path_in_repo=path_in_repo,
                             repo_id=self.repo_id, repo_type="dataset")


def make_api(hub_repo: str, token: Optional[str] = None):
    """'local:DIR' (or an existing dir / absolute path) -> LocalHubAPI;
    anything else -> HfHubAPI."""
    if hub_repo.startswith("local:"):
        return LocalHubAPI(hub_repo[len("local:"):])
    if os.path.isabs(hub_repo) or os.path.isdir(hub_repo):
        return LocalHubAPI(hub_repo)
    return HfHubAPI(hub_repo, token=token)


class EvaluationTracker:
    """Push eval artifacts + regenerate the metadata card."""

    def __init__(self, hub_repo: str, model_name: str,
                 token: Optional[str] = None):
        self.api = make_api(hub_repo, token=token)
        self.model_name = sanitize_model_name(model_name)

    def push(self, reports: Sequence, output_path: str,
             date: Optional[str] = None) -> List[str]:
        """Upload one dated aggregated-results JSON (all tasks) plus each
        task's per-sample JSONL when present under `output_path/{task}/`.

        Mirrors save_results_aggregated + save_results_samples
        (evaluation_tracker.py:170-320). Returns the repo paths written.
        """
        date = date or datetime.datetime.now().strftime(_DATE_FMT)
        written: List[str] = []

        agg = {
            "model_name": self.model_name,
            "date": date,
            "results": {r.task: r.metrics for r in reports},
            "num_docs": {r.task: r.num_docs for r in reports},
            "metadata": next((r.metadata for r in reports if r.metadata), {}),
        }
        results_repo_path = f"{self.model_name}/results_{date}.json"
        tmp = os.path.join(output_path, f"_hub_results_{date}.json")
        with open(tmp, "w") as f:
            json.dump(agg, f, indent=2)
        self.api.upload_file(tmp, results_repo_path)
        os.remove(tmp)
        written.append(results_repo_path)

        for r in reports:
            task_dir = os.path.join(output_path, r.task)
            if not os.path.isdir(task_dir):
                continue
            # rank-merged samples first, else the union of rank shards.
            cands = [os.path.join(task_dir, f) for f in sorted(os.listdir(task_dir))
                     if f.startswith("samples.") and f.endswith(".jsonl")]
            if not cands:
                continue
            repo_path = f"{self.model_name}/samples_{r.task}_{date}.jsonl"
            if len(cands) == 1:
                self.api.upload_file(cands[0], repo_path)
            else:
                merged = []
                for c in cands:
                    with open(c) as f:
                        merged.extend(
                            line if line.endswith("\n") else line + "\n"
                            for line in f if line.strip())
                self.api.upload_text("".join(merged), repo_path)
            written.append(repo_path)
        return written

    def recreate_metadata_card(self) -> str:
        """Regenerate README.md: YAML `configs` mapping every model's dated
        results/sample files to splits, with "latest" pointing at the newest
        (evaluation_tracker.py:324-452). Returns the card text."""
        files = self.api.list_repo_files()
        results: Dict[str, List[tuple]] = {}   # model -> [(date, path)]
        samples: Dict[tuple, List[tuple]] = {}  # (model, task) -> [(date, path)]
        for path in files:
            parts = path.split("/")
            if len(parts) != 2:
                continue
            model, fname = parts
            m = _RESULTS_RE.match(fname)
            if m:
                results.setdefault(model, []).append((m.group("date"), path))
                continue
            m = _SAMPLES_RE.match(fname)
            if m:
                samples.setdefault((model, m.group("task")), []).append(
                    (m.group("date"), path))

        def config_block(name: str, dated: List[tuple]) -> dict:
            dated = sorted(dated)
            data_files = [{"split": re.sub(r"[^\w\.]", "_", d), "path": [p]}
                          for d, p in dated]
            data_files.append({"split": "latest", "path": [dated[-1][1]]})
            return {"config_name": name, "data_files": data_files}

        configs = []
        for model in sorted(results):
            configs.append(config_block(f"{model}__results", results[model]))
        for (model, task) in sorted(samples):
            configs.append(config_block(f"{model}__{task}", samples[(model, task)]))

        # Minimal YAML writer (stable layout; avoids a yaml dependency).
        lines = ["---", "configs:"]
        for c in configs:
            lines.append(f"- config_name: {c['config_name']}")
            lines.append("  data_files:")
            for df in c["data_files"]:
                lines.append(f"  - split: {df['split']}")
                lines.append("    path:")
                for p in df["path"]:
                    lines.append(f"    - {p}")
        lines += ["---", "", "# videoitg-tpu evaluation results",
                  "", "Aggregated results and per-sample logs pushed by "
                  "`videoitg-eval --hub_repo ...` (one dated file per run; "
                  "the `latest` split of each config tracks the newest run).",
                  ""]
        card = "\n".join(lines)
        self.api.upload_text(card, "README.md")
        return card
