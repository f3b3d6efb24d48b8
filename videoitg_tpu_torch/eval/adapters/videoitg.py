"""Grounding-stage adapter: score frames, emit results.jsonl rows.

Counterpart of videoitg_tpu/eval/adapters/videoitg.py on the port's
SelectionEngine. Parity: lmms_eval/models/videoitg.py — the harness
"response" for this stage is incidental; the useful output is the per-doc
selection row {doc_id, video_path, contexts, index (score-desc), logits
(2dp), num_frames} consumed by downstream wrappers. Sampling uses the
eval-path rounding (videoitg.py:82-93), 512 frames @ target_fps=1 by default.

Every constructor argument of the JAX adapter keeps its meaning, with these
differences: `device` (None = the card; a missing card is an error unless
device="cpu") stands in for JAX_PLATFORMS; dp / tp / sp / pp above 1 are
refused (multi-device: ROADMAP queue 1, item 8), as is a serving checkpoint
as `pretrained` (item 4).
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

import torch

from videoitg_tpu_torch.eval.api import ModelAdapter, Task, register_adapter
from videoitg_tpu_torch.utils.common import call_with_data_root as _call_with_root

_TOOL = "videoitg adapter"


def _resolve_device(device) -> torch.device:
    """The card unless the caller asked for the CPU; no card is an error."""
    from videoitg_tpu_torch.cli._model_loading import resolve_device

    if device is None or torch.device(device).type == "cuda":
        resolve_device(False, _TOOL, "device=cpu")  # raises with no card
        return torch.device(device or "cuda")
    return torch.device(device)


def _init_grounding_int8(cfg, generator: torch.Generator, device, dtype):
    """A random grounding model whose LM is drawn directly in int8 serving
    form: the dense 8B LM never exists on the device."""
    from videoitg_tpu_torch.models.grounding import GroundingModel
    from videoitg_tpu_torch.ops.quant import init_qwen2_int8

    lm = init_qwen2_int8(cfg.lm, generator, device=device, dtype=dtype)
    return GroundingModel(cfg, device=device, dtype=dtype, generator=generator, lm=lm)


@register_adapter("videoitg")
class VideoITGAdapter(ModelAdapter):
    def __init__(
        self,
        pretrained: Optional[str] = None,
        preset: str = "videoitg-8b",
        random_init: bool = False,
        num_frames: int = 512,
        target_fps: float = 1.0,
        multiple: int = 1,
        data_root: str = "",
        dtype: Optional[str] = None,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        act_int8: bool = False,
        dp: Optional[int] = None,
        tp: Optional[int] = None,
        sp: int = 1,
        pp: int = 1,
        decode_workers: int = 4,
        decode_ahead: int = 4,
        frame_cache_dir: Optional[str] = None,
        batch_size: int = 1,
        transfer: str = "rgb",
        device: Optional[str] = None,
        **_ignored,
    ):
        from videoitg_tpu_torch.cli._model_loading import load_grounding_components
        from videoitg_tpu_torch.engine import SelectionEngine
        from videoitg_tpu_torch.utils.common import resolve_dtype

        meshed = {k: v for k, v in (("dp", dp), ("tp", tp), ("sp", sp), ("pp", pp))
                  if v is not None and v > 1}
        if meshed:
            raise NotImplementedError(
                f"{_TOOL}: {meshed} needs a device mesh, which is not ported to PyTorch "
                "yet (ROADMAP queue 1, item 8)")
        dev = _resolve_device(device)
        tdtype = resolve_dtype(dtype, dev)

        if pretrained:
            from videoitg_tpu_torch.checkpoint import is_serving_checkpoint

            if is_serving_checkpoint(pretrained):
                raise NotImplementedError(
                    f"{_TOOL}: pretrained={pretrained} is a serving checkpoint "
                    "(serving_config.json); serving checkpoints are not ported to "
                    "PyTorch yet (ROADMAP queue 1, item 4)")
            params, cfg, tokenizer = load_grounding_components(
                pretrained, preset, False, tdtype, dev, tool=_TOOL)
        elif random_init and quantize_int8:
            # Init directly in int8 serving form — materializing 8B bf16
            # first would not fit beside the int8 copy.
            from videoitg_tpu_torch.config import preset as get_preset
            from videoitg_tpu_torch.utils.common import CharTokenizer

            cfg = get_preset(preset)
            params = _init_grounding_int8(
                cfg, torch.Generator(device=dev).manual_seed(0), dev, tdtype)
            tokenizer = CharTokenizer(cfg.lm.vocab_size)
            quantize_int8 = False  # already quantized
            print(f"[{_TOOL}] WARNING: random weights — scores are noise", file=sys.stderr)
        elif random_init:
            params, cfg, tokenizer = load_grounding_components(
                None, preset, True, tdtype, dev, seed=0, tool=_TOOL)
        else:
            raise ValueError("pass pretrained=DIR or random_init=True")

        from videoitg_tpu_torch.ops import quant

        if quantize_int8:
            quant.quantize_grounding_int8(params)
        if quantize_int4:
            # Packed-nibble int4 LM weights; larger quantization error than
            # int8 — the reference's bitsandbytes load_in_4bit analog.
            quant.quantize_qwen2_int4(params.lm)
        if act_int8:
            quant.apply_full_int8(params)

        self.engine = SelectionEngine(
            params, cfg, tokenizer, device=dev, num_frames=num_frames,
            target_fps=target_fps, dtype=tdtype, transfer=transfer,
        )
        self.num_frames = num_frames
        self.target_fps = target_fps
        self.multiple = multiple
        self.data_root = data_root
        self.decode_workers = decode_workers
        self.decode_ahead = decode_ahead
        self.batch_size = batch_size
        self.frame_cache = None
        if frame_cache_dir:
            from videoitg_tpu_torch.data.frame_cache import FrameCache

            self.frame_cache = FrameCache(frame_cache_dir)

    def generate_until(self, items: List[tuple], task: Task, writer=None) -> List[str]:
        from videoitg_tpu_torch.data.prefetch import decode_ahead
        from videoitg_tpu_torch.data.sampling import frame_bucket
        from videoitg_tpu_torch.models.projector import inference_hw

        responses = {}
        # Group docs by video: benchmarks ask several questions of the same
        # video (Video-MME: 3/video; VideoITG-40K: ~12 annotations/video).
        # The tower never sees the question, so one decode+encode serves
        # every question of that video (engine.select_many); the reference
        # re-runs the whole model per doc (lmms_eval/models/videoitg.py
        # generate_until loop, infer.py:53-79).
        by_video: dict = {}
        order: List[str] = []
        for doc_id, doc in items:
            if writer is not None and writer.is_done(doc_id):
                # Resume: reconstruct the response from the stored selection
                # row so per-doc records stay correct across restarts.
                row = writer.get_row(doc_id)
                responses[doc_id] = json.dumps({"index": row["index"][:8]})
                continue
            video_path = _call_with_root(task.doc_to_visual, doc, self.data_root)
            contexts = task.doc_text(doc, self.data_root, self.model_name)
            if video_path not in by_video:
                by_video[video_path] = []
                order.append(video_path)
            by_video[video_path].append((doc_id, contexts))
        work = [(vp, vp, by_video[vp]) for vp in order]

        # Same-shape videos are scored together: grouped by (bucket, HW) so
        # one compiled program serves the whole group (512-frame workloads
        # collapse to a single group).
        pending: dict = {}

        def emit(doc_id, video_path, contexts, index, logits):
            row = {
                "index": index, "logits": logits, "num_frames": 1,
                "contexts": contexts, "video_path": video_path,
                "doc_id": doc_id,
            }
            if writer is not None:
                writer.write(row)
            responses[doc_id] = json.dumps({"index": index[:8]})

        def flush(group):
            decs = pending.pop(group, [])
            if not decs:
                return
            scores = self.engine.score_frames(
                [d.frames for d in decs], [d.meta[0][1] for d in decs])
            for d, sc in zip(decs, scores):
                index, logits = self.engine.rank_frames(sc, d.sampled)
                emit(d.meta[0][0], d.key, d.meta[0][1], index, logits)

        # Host decode runs ahead of device scoring on a thread pool.
        for dec in decode_ahead(
            work, num_frames=self.num_frames, target_fps=self.target_fps,
            sampling="eval", multiple=self.multiple,
            workers=self.decode_workers, ahead=max(self.decode_ahead, self.batch_size),
            frame_cache=self.frame_cache, pix_fmt=self.engine.transfer,
            post=self.engine.preprocess_ahead,
        ):
            if dec.error is not None:
                print(f"[videoitg adapter] decode failed for {dec.key}: "
                      f"{dec.error}", file=sys.stderr)
                for doc_id, _ctx in dec.meta:
                    responses[doc_id] = "[decode-error]"
                continue
            if len(dec.meta) > 1:
                # Multi-question video: encode once, score per question.
                results = self.engine.select_many(
                    dec.frames, dec.sampled,
                    [ctx for _d, ctx in dec.meta], video_path=dec.key,
                    doc_ids=[d for d, _ctx in dec.meta])
                for r in results:
                    emit(r.doc_id, r.video_path, r.contexts, r.index,
                         r.logits)
                continue
            t = dec.frames.shape[0]
            group = (frame_bucket(t, self.engine.buckets),
                     inference_hw(self.engine.cfg.projector, t,
                                  self.engine.cfg.vision.num_patches_per_side))
            pending.setdefault(group, []).append(dec)
            if len(pending[group]) >= self.batch_size:
                flush(group)
        for group in list(pending):
            flush(group)
        return [responses[doc_id] for doc_id, _doc in items]

