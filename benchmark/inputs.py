"""The general traffic generator: videos and instructions from a mix's
parameters and the seed.

A mix file (benchmark/traffic/<mix>.json) gives:

* `videos`, `frames`, `height`, `width`: a pool of that many uint8 RGB
  videos, made on the device from the seed and kept on the host in pageable
  memory, as a decoder hands them over; each frame is a smooth random image
  (a coarse `grid` of colours, bilinearly enlarged) plus uniform noise of
  +-`noise` levels;
* `instructions`, `chars`: a pool of that many instructions whose lengths
  are the same evenly spaced set for every seed, in an order and with words
  the seed draws, so that every seed asks for the same work;
* `kind` and its own keys (`questions_per_video`), read by the client
  benchmark/traffic/kinds/<kind>.py.

The same seed gives the same bytes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

WORDS = ("the person a red car dog ball kitchen holding what when does who is on in "
         "after before walks opens table door window man woman child cup phone bag "
         "green blue runs sits picks up puts down screen shows game player scores goal "
         "first last time how many where happens end start near far left right").split()


def derive(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclass
class Traffic:
    mix: dict
    videos: List[np.ndarray]  # [frames, height, width, 3] uint8, host memory
    instructions: List[str]


def make_videos(mix: dict, seed: int, device) -> List[np.ndarray]:
    gen = torch.Generator(device=device).manual_seed(derive(seed, "videos"))
    t, h, w = mix["frames"], mix["height"], mix["width"]
    gh, gw = mix["grid"]
    out = []
    for _ in range(mix["videos"]):
        frames = np.empty((t, h, w, 3), dtype=np.uint8)
        host = torch.from_numpy(frames)  # the same (pageable) memory
        for i in range(0, t, 64):
            n = min(64, t - i)
            coarse = torch.rand((n, 3, gh, gw), generator=gen, device=device) * 255.0
            img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                                  align_corners=False)
            noise = torch.randint(-mix["noise"], mix["noise"] + 1, (n, 3, h, w), generator=gen,
                                  device=device)
            img = (img.round() + noise).clamp(0, 255).to(torch.uint8)
            host[i: i + n].copy_(img.permute(0, 2, 3, 1).contiguous())
        out.append(frames)
    return out


def make_instructions(mix: dict, seed: int) -> List[str]:
    rng = np.random.default_rng(derive(seed, "instructions"))
    lo, hi = mix["chars"]
    lengths = np.linspace(lo, hi, mix["instructions"]).round().astype(int)
    rng.shuffle(lengths)
    out = []
    for n in lengths:
        words: List[str] = []
        while len(" ".join(words)) < n:
            words.append(WORDS[rng.integers(len(WORDS))])
        text = " ".join(words)[: n - 1]
        if text.endswith(" "):
            text = text[:-1] + "s"
        out.append(text[0].upper() + text[1:] + "?")
    return out


def make_traffic(mix: dict, seed: int, device) -> Traffic:
    return Traffic(mix, make_videos(mix, seed, device), make_instructions(mix, seed))
