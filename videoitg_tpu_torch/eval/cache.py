"""Response caching for eval reruns.

Parity: the reference's CachingLMM sqlitedict wrapper
(lmms_eval/api/model.py:130-221) memoizes model responses keyed by request.
Here a stdlib-sqlite cache wraps any ModelAdapter; keys hash
(adapter name, task, doc_id, prompt) so config changes invalidate naturally.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
from typing import List, Optional

from videoitg_tpu_torch.eval.api import ModelAdapter, Task


class ResponseCache:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS responses (key TEXT PRIMARY KEY, value TEXT)"
        )
        self.conn.commit()

    def get(self, key: str) -> Optional[str]:
        row = self.conn.execute(
            "SELECT value FROM responses WHERE key = ?", (key,)
        ).fetchone()
        return None if row is None else json.loads(row[0])

    def put(self, key: str, value: str) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO responses (key, value) VALUES (?, ?)",
            (key, json.dumps(value)),
        )
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()


def _key(model_tag: str, task_name: str, doc_id, prompt: str) -> str:
    h = hashlib.sha256(f"{model_tag}\x00{task_name}\x00{doc_id}\x00{prompt}".encode())
    return h.hexdigest()


class CachingAdapter(ModelAdapter):
    """Wrap an adapter with a persistent response cache."""

    def __init__(self, inner: ModelAdapter, cache_path: str, model_tag: str = ""):
        self.inner = inner
        self.cache = ResponseCache(cache_path)
        self.model_tag = model_tag or type(inner).__name__

    def _cached_request(self, request: str, items: List[tuple], task: Task,
                        writer, extra_key=None):
        data_root = getattr(self.inner, "data_root", "")

        def prompt_of(doc):
            # Key on the model's RESOLVED prompt (per-model overrides apply),
            # so an override change invalidates stale cached responses.
            prompt = task.doc_text(
                doc, data_root, getattr(self.inner, "model_name", None))
            if extra_key is not None:
                prompt = f"{prompt}\x00{extra_key(doc)}"
            return prompt

        keys = [
            _key(f"{self.model_tag}|{request}", task.name, doc_id, prompt_of(doc))
            for doc_id, doc in items
        ]
        cached = [self.cache.get(k) for k in keys]
        missing = [(it, k) for it, k, c in zip(items, keys, cached) if c is None]
        if missing:
            fn = getattr(self.inner, request)
            fresh = fn([it for it, _ in missing], task, writer=writer)
            for (it, k), resp in zip(missing, fresh):
                # An empty string is the adapters' all-retries-failed
                # sentinel (e.g. api_chat._post) — don't persist it, so an
                # interrupted/flaky sweep retries those docs on rerun
                # instead of permanently caching a wrong answer.
                if resp == "":
                    continue
                self.cache.put(k, resp)
            it_fresh = iter(fresh)
            cached = [c if c is not None else next(it_fresh) for c in cached]
        return cached

    def generate_until(self, items: List[tuple], task: Task, writer=None) -> List[str]:
        return self._cached_request("generate_until", items, task, writer)

    def generate_until_multi_round(self, items: List[tuple], task: Task,
                                   writer=None) -> List[str]:
        return self._cached_request("generate_until_multi_round", items, task,
                                    writer)

    def loglikelihood(self, items: List[tuple], task: Task, writer=None):
        """Cache (ll, is_greedy) pairs; the key also covers the continuation
        (doc_to_target) so different candidates never collide. JSON stores
        tuples as lists — normalize back on the way out."""
        extra = task.doc_to_target if task.doc_to_target else None
        out = self._cached_request("loglikelihood", items, task, writer,
                                   extra_key=extra)
        return [(float(r[0]), bool(r[1])) for r in out]
