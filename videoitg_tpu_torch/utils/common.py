"""Small shared helpers (the port's copy of what it needs from
videoitg_tpu/utils/common.py)."""

from __future__ import annotations


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
