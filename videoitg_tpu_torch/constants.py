"""Shared constants.

Parity: eagle/constants.py:9-15 in the reference defines the same sentinel
values; they are part of the on-disk data contract (training JSONs embed
"<image>" and tokenized prompts splice IMAGE_TOKEN_INDEX), so the values
must match exactly.
"""

# Label value ignored by the language-model loss.
IGNORE_INDEX = -100

# Sentinel token id spliced into input_ids where image embeddings go.
IMAGE_TOKEN_INDEX = -200

# Literal placeholder in prompt text.
DEFAULT_IMAGE_TOKEN = "<image>"

# Token-type codes used to describe every position of the packed sequence.
# Parity: eagle/model/eagle_archv1.py:277 (1=instruction/ignored text,
# 2=answer text, 3=image token, 4=padding).
TOKEN_TYPE_INSTRUCTION = 1
TOKEN_TYPE_ANSWER = 2
TOKEN_TYPE_IMAGE = 3
TOKEN_TYPE_PAD = 4
