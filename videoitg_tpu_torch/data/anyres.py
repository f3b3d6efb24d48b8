"""AnyRes (LLaVA-style) high-resolution image tiling.

Host-side counterpart of the reference's anyres helpers
(eagle/mm_utils.py:106-239): pick the best grid resolution for an
arbitrary image from a set of pinpoints, letterbox-resize into it,
slice into ViT-sized tiles, and prepend the base (global) view.

TPU notes: tiling happens on host (like all image IO here); the output
is a single [N, tile, tile, 3] uint8 stack whose N is determined by the
chosen pinpoint — a CLOSED set per model config — so downstream device
programs see a small fixed family of static shapes (bucket by N exactly
like frame counts, data/sampling.frame_bucket). The VideoITG-8B video
path never tiles (one 384x384 view per frame, SURVEY §2 L1); this serves
image-capable downstream adapters and the anyres checkpoints' configs.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]],
                           ) -> Tuple[int, int]:
    """Pinpoint with max effective resolution, ties by least waste
    (mm_utils.py:106-133). Sizes are (width, height)."""
    ow, oh = original_size
    best = None
    best_eff = 0
    best_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best_eff, best_waste, best = eff, waste, (w, h)
    return best


def resize_and_pad_image(image, target_resolution: Tuple[int, int]):
    """Aspect-preserving resize centered on a black canvas
    (mm_utils.py:136-169). PIL in, PIL out — pixel-identical to the
    reference (same PIL default resample, same ceil+min rounding)."""
    from PIL import Image

    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(image, patch_size: int) -> List:
    """Row-major patch_size x patch_size crops (mm_utils.py:172-190)."""
    patches = []
    w, h = image.size
    for top in range(0, h, patch_size):
        for left in range(0, w, patch_size):
            patches.append(image.crop((left, top,
                                       left + patch_size, top + patch_size)))
    return patches


def _parse_pinpoints(grid_pinpoints) -> List[Tuple[int, int]]:
    if isinstance(grid_pinpoints, list):
        return grid_pinpoints
    return ast.literal_eval(grid_pinpoints)


def get_anyres_image_grid_shape(image_size: Tuple[int, int], grid_pinpoints,
                                patch_size: int) -> Tuple[int, int]:
    """(grid_w, grid_h) in tiles after anyres preprocessing
    (mm_utils.py:193-210)."""
    w, h = select_best_resolution(image_size, _parse_pinpoints(grid_pinpoints))
    return w // patch_size, h // patch_size


def anyres_tiles(image: np.ndarray, grid_pinpoints, tile_size: int,
                 shortest_edge: int) -> np.ndarray:
    """[1 + grid_w*grid_h, tile, tile, 3] uint8: global view first, then
    row-major tiles (mm_utils.process_anyres_image:213-239, with the HF
    processor's normalize step factored out — feed the stack to
    ops/preprocess on device instead)."""
    from PIL import Image

    img = Image.fromarray(image)
    best = select_best_resolution(img.size, _parse_pinpoints(grid_pinpoints))
    padded = resize_and_pad_image(img, best)
    tiles = divide_to_patches(padded, tile_size)
    base = img.resize((shortest_edge, shortest_edge))
    if base.size != (tile_size, tile_size):
        base = base.resize((tile_size, tile_size))
    return np.stack([np.asarray(p.convert("RGB"), np.uint8)
                     for p in [base] + tiles])


def process_anyres_image(image, preprocess: Callable, grid_pinpoints,
                         crop_size: int, shortest_edge: int):
    """Reference-shaped driver (mm_utils.py:213-239): global resize +
    tiles, each through `preprocess` (e.g. a SigLIP normalize), stacked on
    a leading axis. `preprocess` maps one PIL image -> array."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    best = select_best_resolution(image.size, _parse_pinpoints(grid_pinpoints))
    padded = resize_and_pad_image(image, best)
    tiles = divide_to_patches(padded, crop_size)
    base = image.resize((shortest_edge, shortest_edge))
    return np.stack([np.asarray(preprocess(p)) for p in [base] + tiles])
