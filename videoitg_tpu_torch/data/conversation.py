"""Conversation templates: plain + ChatML (Qwen) preprocessing.

Parity targets: reference eagle/conversation.py (conv_llava_plain,
conv_qwen) and train_itg.py preprocessors —
  * preprocess_plain (:932-951): "<image>" + answer-text + "\\n"; labels
    mask the image token only (grounding + projector-pretrain stages).
  * preprocess_qwen (:423-496): ChatML "<|im_start|>role\\ncontent<|im_end|>\\n"
    per turn; system + user turns fully masked, assistant turns supervised,
    with <|im_start|>/<|im_end|>/newline ids unmasked (SFT stage).

Both return (input_ids, labels) with IMAGE_TOKEN_INDEX at <image> and
IGNORE_INDEX masking — the raw splice format; pack_for_vlm splits around
the image sentinel into the static [pre | img | post] VLM layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from videoitg_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
)
from videoitg_tpu_torch.data.tokenizer import tokenizer_image_token

CHATML_SYSTEM = "You are a helpful assistant."


def preprocess_plain(
    conversations: Sequence[Dict[str, str]], tokenizer, sep: str = "\n"
) -> Tuple[List[int], List[int]]:
    """2-turn plain template: [IMG] + turn2-text + sep.

    conversations: [{"from": "human", "value": "...<image>..."},
                    {"from": "gpt", "value": answer}].
    """
    assert len(conversations) == 2
    assert DEFAULT_IMAGE_TOKEN in conversations[0]["value"]
    prompt = DEFAULT_IMAGE_TOKEN + conversations[1]["value"] + sep
    input_ids = tokenizer_image_token(prompt, tokenizer)
    masked_len = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))
    labels = list(input_ids)
    for i in range(masked_len):
        labels[i] = IGNORE_INDEX
    return input_ids, labels


def preprocess_chatml(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    system_message: str = CHATML_SYSTEM,
) -> Tuple[List[int], List[int]]:
    """Qwen ChatML SFT preprocessing (reference preprocess_qwen).

    Requires a tokenizer with im_start/im_end special ids (HF Qwen2) exposed
    as `additional_special_tokens_ids` and a callable interface; <image>
    inside user content becomes IMAGE_TOKEN_INDEX.
    """
    roles = {"human": "user", "gpt": "assistant"}
    im_start, im_end = tokenizer.additional_special_tokens_ids[:2]
    newline_ids = set(tokenizer("\n").input_ids)
    unmask = {im_start, im_end} | newline_ids

    def encode_turn(role: str, content: str) -> List[int]:
        # "<|im_start|>" + role + "\n" + content + "<|im_end|>" + "\n"
        ids = [im_start]
        ids += tokenizer(role + "\n").input_ids
        ids += tokenizer_image_token(content, tokenizer)
        ids += [im_end]
        ids += tokenizer("\n").input_ids
        return ids

    convs = list(conversations)
    if convs and roles.get(convs[0].get("from", convs[0].get("role")), "") != "user":
        convs = convs[1:]

    input_ids: List[int] = []
    labels: List[int] = []

    sys_ids = encode_turn("system", system_message)
    input_ids += sys_ids
    labels += [IGNORE_INDEX] * len(sys_ids)

    for turn in convs:
        role = roles.get(turn.get("from", turn.get("role")),
                         turn.get("from", turn.get("role")))
        content = turn.get("value", turn.get("content", ""))
        ids = encode_turn(role, content)
        input_ids += ids
        if role == "assistant":
            labels += ids
        else:
            labels += [IGNORE_INDEX] * len(ids)

    # Unmask structural tokens (reference train_itg.py:484-487).
    for i, tid in enumerate(input_ids):
        if tid in unmask:
            labels[i] = tid
    return input_ids, labels


@dataclass
class PackedVLMText:
    pre_ids: List[int]
    post_ids: List[int]
    post_labels: List[int]


def split_around_image(input_ids: List[int], labels: List[int]) -> PackedVLMText:
    """Split a spliced sequence at the single IMAGE_TOKEN_INDEX into the
    static [pre | img | post] layout consumed by models/vlm.py."""
    assert input_ids.count(IMAGE_TOKEN_INDEX) == 1, "exactly one <image> required"
    k = input_ids.index(IMAGE_TOKEN_INDEX)
    return PackedVLMText(
        pre_ids=input_ids[:k],
        post_ids=input_ids[k + 1:],
        post_labels=labels[k + 1:],
    )
