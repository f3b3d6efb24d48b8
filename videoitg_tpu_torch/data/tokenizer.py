"""Prompt tokenization with the <image> sentinel.

Parity: eagle/mm_utils.py:279-298 `tokenizer_image_token` — the prompt is
split on "<image>", each chunk is tokenized, and IMAGE_TOKEN_INDEX (-200) is
spliced between chunks (with BOS handling for tokenizers that emit one; the
Qwen2 tokenizer emits none).

The grounding prompt is always DEFAULT_IMAGE_TOKEN + instruction + "\\n"
(reference lmms_eval/models/videoitg.py:289, infer.py:60), i.e. the video
comes first. `grounding_text_ids` returns the text that FOLLOWS the image
block, which is what the static packed layout consumes.
"""

from __future__ import annotations

from typing import List

from videoitg_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Tokenize `prompt`, replacing each "<image>" with the sentinel id."""
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    offset = 0
    ids: List[int] = []
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and len(chunks[0]) > 0 and bos is not None and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    interleaved: List[List[int]] = []
    for i, chunk in enumerate(chunks):
        interleaved.append(chunk)
        if i < len(chunks) - 1:
            interleaved.append(sep)
    for x in interleaved:
        ids.extend(x[offset:])
    return ids


def build_grounding_prompt(instruction: str) -> str:
    """The exact grounding prompt string (videoitg.py:289)."""
    return DEFAULT_IMAGE_TOKEN + instruction + "\n"


def grounding_text_ids(instruction: str, tokenizer, max_len: int) -> List[int]:
    """Token ids of the text segment that follows the image block.

    Equivalent to tokenizer_image_token(build_grounding_prompt(x))[1:] for
    image-first prompts; asserts the layout assumption explicitly.
    """
    ids = tokenizer_image_token(build_grounding_prompt(instruction), tokenizer)
    assert ids and ids[0] == IMAGE_TOKEN_INDEX, (
        "grounding prompts must start with <image> (got text before it)"
    )
    text = ids[1:]
    assert IMAGE_TOKEN_INDEX not in text, "multiple <image> tokens unsupported"
    return text[:max_len]
