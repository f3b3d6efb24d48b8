"""Small shared helpers (the port's copy of what it needs from
videoitg_tpu/utils/common.py)."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_dtype(name: Optional[str], device=None) -> torch.dtype:
    """None -> bf16, or fp32 when `device` is the CPU (the JAX package's rule,
    with the device in place of jax's default backend); else the named dtype."""
    if name is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        return torch.float32 if cpu else torch.bfloat16
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def call_with_data_root(fn, doc, data_root: str):
    """Task doc functions optionally accept data_root."""
    try:
        return fn(doc, data_root=data_root)
    except TypeError:
        return fn(doc)


def violates_moderation(text: str, endpoint: str | None = None,
                        timeout: float = 5.0) -> bool:
    """Demo-input moderation hook (reference eagle/utils.py:118-136).

    The reference POSTs to the OpenAI moderation API and fails open (returns
    False on any error). Same contract here: if `endpoint` (or
    $MODERATION_ENDPOINT) is configured, POST {"input": text} and read
    results[0].flagged; unreachable/unset endpoints fail open — with no egress and no
    endpoint set the hook is a documented no-op."""
    import json as _json
    import os
    import urllib.request

    endpoint = endpoint or os.environ.get("MODERATION_ENDPOINT")
    if not endpoint:
        return False
    req = urllib.request.Request(
        endpoint,
        data=_json.dumps({"input": text.replace("\n", "")}).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": "Bearer " + os.environ["OPENAI_API_KEY"]}
                    if "OPENAI_API_KEY" in os.environ else {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return bool(_json.load(resp)["results"][0]["flagged"])
    except Exception:
        return False


class CharTokenizer:
    """Deterministic char-level tokenizer for smoke tests / random-init runs
    (one id per character, modulo the vocab)."""

    bos_token_id = None
    eos_token_id = 0
    additional_special_tokens_ids = [400, 401]  # fake im_start/im_end

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def __call__(self, text):
        r = type("R", (), {})()
        r.input_ids = [ord(c) % self.vocab_size for c in text]
        return r

    def decode(self, ids, **_kw):
        return "".join(chr(max(32, int(i) % 127)) for i in ids)
