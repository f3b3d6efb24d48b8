"""What decides `correct`: the timed path's own scores against the plain
reference (the configuration's architecture module,
benchmark/reference/<name>.py, by default model.py), on a sample of the
requests completed in the window drawn from the seed.

Once the window has closed and the program's state is freed, the weights are
drawn again from the seed (the same bits the program was given) and the
reference scores the sampled requests' videos and instructions at the sizes
the window ran. The numbers are taken on the frames' logits (the scores
before the sigmoid; the program's are recovered from its float32 scores),
over every frame of every sampled request:

* `logit_max`: the widest gap of a frame's logit;
* `logit_crms`: the largest over the requests of the root mean square of a
  request's gaps after its mean gap is taken out: the frame-to-frame part
  of the error, the part an answer to another instruction shows;
* `logit_shift`: the largest |mean gap| of a request: the common part.

The configuration's "check" names the numbers it compares and their limits.
"""

from __future__ import annotations

import time
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.inputs import derive
from benchmark.manifest import reference_module
from benchmark.port import DTYPES
from benchmark.reference.model import with_highest_precision
from benchmark.requests import Request
from benchmark.weights import make_weights


def pick_sample(requests: Sequence[Request], seed: int, groups: int,
                per_group: int) -> List[Request]:
    """`groups` groups of requests (the one holding the longest instruction,
    then others drawn from the seed), and in each its first request, its
    longest instruction, then others drawn from the seed, `per_group` at
    most."""
    rng = np.random.default_rng(derive(seed, "check"))
    by_group: Dict[int, List[Request]] = {}
    for r in requests:
        by_group.setdefault(r.group, []).append(r)
    longest = max(requests, key=lambda r: len(r.instruction)).group
    rest = [g for g in by_group if g != longest]
    rng.shuffle(rest)
    chosen = [longest] + rest[: groups - 1]
    out: List[Request] = []
    for g in chosen:
        rs = by_group[g]
        picks = [rs[0]]
        picks += [r for r in sorted(rs[1:], key=lambda r: -len(r.instruction))][:1]
        others = [r for r in rs if r not in picks]
        rng.shuffle(others)
        out += (picks + others)[:per_group]
    return out


def reference_scores(cfg: dict, seed: int, videos: Sequence[np.ndarray],
                     sample: Sequence[Tuple[int, str]], device,
                     arch: Optional[ModuleType] = None) -> List[np.ndarray]:
    """The reference's scores of (video index, instruction) pairs, with the
    weights drawn again from the seed; each video is encoded once. `arch`,
    the configuration's architecture module, draws the weights and scores
    (by default the module its "reference" names in this checkout)."""
    ref = reference_module(cfg) if arch is None else arch
    with_highest_precision()
    state = make_weights(cfg["model"], derive(seed, "weights"), device, DTYPES[cfg["dtype"]],
                         ref)
    out: List[np.ndarray] = []
    encoded: Dict[int, torch.Tensor] = {}
    with torch.no_grad():
        for video, instruction in sample:
            if video not in encoded:
                encoded.clear()
                frames = torch.from_numpy(videos[video]).to(device)
                encoded[video] = ref.encode(state, cfg, frames)
            out.append(ref.scores(state, cfg, encoded[video], videos[video].shape[0],
                                  instruction))
    return out


def logits_of(scores) -> np.ndarray:
    p = np.clip(np.asarray(scores, np.float64), 1e-12, 1.0 - 1e-12)
    return np.log(p) - np.log1p(-p)


NUMBERS = ("logit_max", "logit_crms", "logit_shift")


def gaps(program: Sequence[np.ndarray], reference: Sequence[np.ndarray]) -> Dict[str, float]:
    """The numbers above; inf for a missing, misshapen or non-finite score."""
    bad = {k: float("inf") for k in NUMBERS}
    diffs = []
    for p, r in zip(program, reference):
        if p is None or np.shape(p) != np.shape(r) or not np.all(np.isfinite(p)):
            return bad
        diffs.append(logits_of(p) - logits_of(r))
    if not diffs:
        return bad
    return {"logit_max": float(max(np.max(np.abs(d)) for d in diffs)),
            "logit_crms": float(max(np.sqrt(np.mean((d - d.mean()) ** 2)) for d in diffs)),
            "logit_shift": float(max(abs(d.mean()) for d in diffs))}


def check(cfg: dict, seed: int, videos, sample: Sequence[Request], device, log,
          arch: ModuleType) -> Dict[str, float]:
    t0 = time.perf_counter()
    ref_scores = reference_scores(cfg, seed, videos,
                                  [(r.video, r.instruction) for r in sample], device, arch)
    numbers = gaps([r.scores for r in sample], ref_scores)
    spread = [float(np.std(logits_of(r))) for r in ref_scores]
    log(f"check: {len(sample)} requests (groups {sorted({r.group for r in sample})}) against "
        f"the reference in {time.perf_counter() - t0:.1f} s (its logits' spread over frames "
        f"{', '.join(f'{x:.4f}' for x in spread)}): "
        + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    return numbers
