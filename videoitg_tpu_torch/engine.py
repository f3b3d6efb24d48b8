"""SelectionEngine: videos + instruction -> ranked frame indices, in PyTorch.

Counterpart of videoitg_tpu/engine.py. Decoded uint8 frames go to the device,
are resized and normalised there, padded with black frames to a static
frame bucket, and scored in one bidirectional prefill; the result follows
the reference's results.jsonl contract (score-descending order, stable on
ties, 2-dp scores). hw comes from the REAL frame count, as in the reference
projector. A model in a quantised serving tier (ops/quant.py) runs through
the same entry points; `qgemm` / `fused` (default: VIDEOITG_QGEMM /
VIDEOITG_FUSED, read once here) say which act8 products run in the
hand-written int8 kernels, and `lm_splash` (default: VIDEOITG_LM_SPLASH, read
once here) sends the LM's attention through the splash MQA kernel instead of
the flash kernel (the JAX package's A/B arm). `transfer="yuv420"` takes the
decoder's native planes (data.video.YUVFrames, half the host-to-device
bytes) and converts them to RGB on the device.

`mesh=` (parallel/mesh.make_mesh) serves on a ([pp,] dp, tp[, sp]) device
mesh, one process per device, every rank calling the engine with the same
inputs and getting the same result: the weights are sharded at
construction (parallel/sharding.py); dp splits the tower's frames, a
score_frames batch and the questions of score_encoded, gathering the results;
tp splits heads and MLP features (parallel/tensor.py); sp runs the LM's
attention as a ring (parallel/ring_attention.py); pp runs the decoder as a
microbatch pipeline (parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.data.sampling import FRAME_BUCKETS, frame_bucket
from videoitg_tpu_torch.data.tokenizer import grounding_text_ids
from videoitg_tpu_torch.data.video import YUVFrames
from videoitg_tpu_torch.models.grounding import (
    GroundingBatch,
    GroundingModel,
    grounding_logits,
    grounding_logits_from_tokens,
    vision_features,
)
from videoitg_tpu_torch.models.projector import apply_projector, frame_token_count, inference_hw
from videoitg_tpu_torch.ops.attention import resolve_lm_splash
from videoitg_tpu_torch.ops.preprocess import preprocess_frames, preprocess_frames_yuv
from videoitg_tpu_torch.ops.quant import Act8Switches, cast_params
from videoitg_tpu_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class SelectionResult:
    """Full score-ranked frame listing for one video.

    `index` holds every sampled original-frame id sorted by score descending
    and `logits` the matching sigmoid scores rounded to 2 dp: the reference's
    results.jsonl row. Top-K takes the first k and sorts them ascending.
    """

    index: List[int]
    logits: List[float]
    num_frames: int
    contexts: str
    video_path: str
    doc_id: Optional[object] = None
    sampled_frames: Optional[List[int]] = None
    raw_scores: Optional[np.ndarray] = None

    def topk(self, k: int) -> List[int]:
        return sorted(self.index[:k])

    def to_reference_json(self) -> Dict:
        return {
            "index": self.index,
            "logits": self.logits,
            "num_frames": self.num_frames,
            "contexts": self.contexts,
            "video_path": self.video_path,
            "doc_id": self.doc_id,
        }


class PreprocessedVideo(NamedTuple):
    """A video resized/normalised on the device and padded to its bucket.
    `ready` marks, on a CUDA device, the point of the producing stream after
    which `pix` is complete; the consumer's stream waits for it."""

    pix: torch.Tensor  # [t_bucket, S, S, 3], model dtype
    t_real: int
    ready: Optional["torch.cuda.Event"] = None

    @property
    def shape(self):
        return (self.t_real,) + tuple(self.pix.shape[1:])


class EncodedVideo(NamedTuple):
    """A video's tower features on the device, reusable across questions
    (the tower does not see the instruction)."""

    feats: torch.Tensor  # [t_bucket, P, C], model dtype
    t_real: int

    @property
    def t_bucket(self) -> int:
        return self.feats.shape[0]


class SelectionEngine:
    def __init__(
        self,
        params: GroundingModel,
        cfg: GroundingConfig,
        tokenizer,
        device: Optional[torch.device] = None,
        num_frames: int = 512,
        target_fps: float = 1.0,
        dtype: torch.dtype = torch.bfloat16,
        use_flash: Optional[bool] = None,
        batch_size: int = 1,
        buckets: Sequence[int] = FRAME_BUCKETS,
        vision_chunk: Optional[int] = None,
        mesh=None,
        transfer: str = "rgb",
        qgemm: Optional[bool] = None,
        fused: Optional[bool] = None,
        lm_splash: Optional[bool] = None,
    ):
        if transfer not in ("rgb", "yuv420"):
            raise ValueError(f"transfer must be 'rgb' or 'yuv420', got {transfer!r}")
        # "yuv420": the decoder ships its native planes and the BT.601 -> RGB
        # conversion runs on the device. Scores match the RGB path within
        # colourspace rounding; "rgb" stays the default.
        self.transfer = transfer
        # No `device` means where the caller put the model: a model on the card
        # is served on the card, never moved to the CPU unasked.
        self.device = torch.device(device if device is not None
                                   else next(params.parameters()).device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.target_fps = target_fps
        self.dtype = dtype
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.use_flash = self.device.type == "cuda" if use_flash is None else use_flash
        # Bound tower activations at long buckets, as the JAX engine does.
        self.vision_chunk = 128 if vision_chunk is None else vision_chunk
        self.act8 = Act8Switches.from_env(qgemm=qgemm, fused=fused)
        self.lm_splash = resolve_lm_splash(lm_splash)
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                                f"(parallel/mesh.make_mesh), got {type(mesh).__name__}")
            params = self._shard(params, cfg, mesh)
        self.model = cast_params(params, dtype, device=self.device).eval()
        self.timer = StageTimer()

    @staticmethod
    def _shard(params: GroundingModel, cfg: GroundingConfig, mesh) -> GroundingModel:
        """This rank's slice of the weights: dense specs adapted to the
        actual tree (int8 / int4 leaves shard like w, scales follow the out
        axis); a pp axis also splits the decoder layers into stages."""
        from videoitg_tpu_torch.parallel import sharding
        from videoitg_tpu_torch.parallel.mesh import TP_AXIS, mesh_coords, mesh_shape

        shape = mesh_shape(mesh)
        tp = shape.get(TP_AXIS, 1)
        for what, n in (("LM q", cfg.lm.num_heads), ("LM kv", cfg.lm.num_kv_heads),
                        ("vision", cfg.vision.num_heads)):
            if n % tp != 0:
                raise ValueError(
                    f"tp={tp} does not divide {what} head count {n}; "
                    f"pick tp from divisors (e.g. tp<=({cfg.lm.num_kv_heads}))")
        specs = sharding.grounding_param_specs(pp=shape.get("pp", 1) > 1)
        return sharding.shard_model(params, specs, shape, mesh_coords(mesh),
                                    tp_group=mesh.get_group(TP_AXIS) if tp > 1 else None)

    def _mesh_ctx(self):
        """Ambient contexts of a mesh-backed call: the attention mesh always,
        plus the decoder pipeline when the mesh carries a pp axis; nothing
        without a mesh."""
        import contextlib

        from videoitg_tpu_torch.parallel import context as par_context
        from videoitg_tpu_torch.parallel.mesh import axis_size

        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(par_context.attention_mesh(self.mesh))
            if axis_size(self.mesh, "pp") > 1:
                stack.enter_context(par_context.pipeline_mesh(self.mesh))
        return stack

    def _dp(self) -> int:
        from videoitg_tpu_torch.parallel.mesh import DP_AXIS, axis_size

        return axis_size(self.mesh, DP_AXIS)

    def _tokenize(self, instructions: Sequence[str]):
        ids = np.zeros((len(instructions), self.cfg.max_text_len), np.int64)
        valid = np.zeros(ids.shape, dtype=bool)
        for i, instr in enumerate(instructions):
            tok = grounding_text_ids(instr, self.tokenizer, self.cfg.max_text_len)
            ids[i, : len(tok)] = tok
            valid[i, : len(tok)] = True
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _frame_valid(self, t_reals: Sequence[int], t_bucket: int) -> torch.Tensor:
        fv = torch.zeros(len(t_reals), t_bucket, dtype=torch.bool)
        for i, t in enumerate(t_reals):
            fv[i, :t] = True
        return fv.to(self.device)

    @torch.inference_mode()
    def _preprocess(self, frames_u8, t_bucket: int) -> torch.Tensor:
        """uint8 frames (RGB [T, H, W, 3], numpy or tensor, or YUVFrames) ->
        [t_bucket, S, S, 3] model dtype on the device, padded with black
        frames. A PreprocessedVideo passes through, after the current stream
        has been made to wait for it."""
        if isinstance(frames_u8, PreprocessedVideo):
            if frames_u8.pix.shape[0] != t_bucket:
                raise ValueError(
                    f"preprocessed input padded to {frames_u8.pix.shape[0]} frames, "
                    f"bucket needs {t_bucket}; preprocess_ahead with the same bucket set")
            if frames_u8.ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(frames_u8.ready)
                frames_u8.pix.record_stream(stream)
            return frames_u8.pix
        out_size = self.cfg.vision.image_size
        if isinstance(frames_u8, YUVFrames):
            t = frames_u8.shape[0]
            planes = [torch.as_tensor(p).to(self.device) for p in frames_u8]
            if t < t_bucket:
                # Black in YUV is y = 0 (it clips to 0 after the -16 offset)
                # with NEUTRAL chroma 128: zero chroma would come out green.
                planes = [torch.cat([p, p.new_full((t_bucket - t,) + tuple(p.shape[1:]), fill)])
                          for p, fill in zip(planes, (0, 128, 128))]
            y, u, v = planes
            return preprocess_frames_yuv(y, u, v, out_size=out_size, dtype=self.dtype)
        x = torch.as_tensor(frames_u8).to(self.device)
        t, h, w, _ = x.shape
        if t < t_bucket:
            x = torch.cat([x, x.new_zeros((t_bucket - t, h, w, 3))])
        return preprocess_frames(x, out_size=out_size, dtype=self.dtype)

    # ---- public API ----

    def preprocess_ahead(self, frames, t_bucket: Optional[int] = None) -> PreprocessedVideo:
        """Resize/normalise and upload a decoded video now; feed the result
        to select() / score_frames() / encode_video() in place of raw frames.

        Safe to call from a decode worker thread (data/prefetch.decode_ahead
        `post=`). The upload is a plain copy from pageable memory on the
        calling thread's current stream; with PyTorch's defaults that is the
        device's one default stream, so the copy and the resize queue behind
        whatever the scoring thread has already enqueued, and the worker
        thread blocks on the copy, not the scoring thread. The result carries
        an event recorded after the last preprocessing kernel; the consumer's
        stream waits for it before it reads `pix`, which also holds when a
        caller has put either thread on a stream of its own."""
        t_real = frames.shape[0]
        if t_bucket is None:
            t_bucket = frame_bucket(t_real, self.buckets)
        pix = self._preprocess(frames, t_bucket)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return PreprocessedVideo(pix, t_real, ready)

    @torch.inference_mode()
    def encode_video(self, frames, t_bucket: Optional[int] = None) -> EncodedVideo:
        """Preprocess + vision tower once; reuse across questions."""
        t_real = frames.t_real if isinstance(frames, PreprocessedVideo) else frames.shape[0]
        if t_bucket is None:
            t_bucket = frame_bucket(t_real, self.buckets)
        with self.timer.stage("preprocess"):
            pix = self._preprocess(frames, t_bucket)
        with self.timer.stage("tower"), self._mesh_ctx():
            chunk, dp = self.vision_chunk, self._dp()
            if not (t_bucket > chunk and t_bucket % chunk == 0):
                chunk = 0
            # Under dp the tower's frames split over the dp line when every
            # chunk (or the unchunked bucket) divides by dp; each rank runs
            # its share in chunks of chunk / dp and the features are gathered.
            if dp > 1 and (chunk % dp == 0 if chunk else t_bucket % dp == 0):
                from videoitg_tpu_torch.parallel.mesh import dp_share, gather_dp

                feats = vision_features(self.model, pix[dp_share(t_bucket, self.mesh)],
                                        self.cfg, use_flash=self.use_flash,
                                        vision_chunk=chunk // dp, act8=self.act8)
                feats = gather_dp(feats, self.mesh)
            else:
                feats = vision_features(self.model, pix, self.cfg, use_flash=self.use_flash,
                                        vision_chunk=self.vision_chunk, act8=self.act8)
        return EncodedVideo(feats, t_real)

    @torch.inference_mode()
    def score_encoded(self, enc: EncodedVideo, instructions: Sequence[str]) -> List[np.ndarray]:
        """Score N instructions against one encoded video (tower skipped):
        the projector runs once, then one LM pass per question. Under dp the
        questions run dp at a time, rank r taking question g dp + r of group
        g, the last group padded by repeating its final question."""
        if not instructions:
            return []
        cfg = self.cfg
        hw = inference_hw(cfg.projector, enc.t_real, cfg.vision.num_patches_per_side)
        n_pf = frame_token_count(cfg.projector, hw, cfg.vision.num_patches)
        fv = self._frame_valid([enc.t_real], enc.t_bucket)
        n, dp = len(instructions), self._dp()
        padded = list(instructions) + [instructions[-1]] * (-n % dp)
        mine = range(len(padded))
        if dp > 1:
            from videoitg_tpu_torch.parallel.mesh import DP_AXIS, mesh_coords

            mine = range(mesh_coords(self.mesh)[DP_AXIS], len(padded), dp)
        ids, valid = self._tokenize([padded[i] for i in mine])
        with self.timer.stage("score"), self._mesh_ctx():
            img = apply_projector(self.model.projector, enc.feats, cfg.projector, hw=hw)
            img = img.reshape(1, enc.t_bucket * n_pf, -1)
            probs = []
            for i in range(len(mine)):
                logits = grounding_logits_from_tokens(
                    self.model, img, fv, ids[i: i + 1], valid[i: i + 1], cfg,
                    n_pf=n_pf, use_flash=self.use_flash, act8=self.act8,
                    lm_splash=self.lm_splash)
                probs.append(torch.sigmoid(logits.float())[0, : enc.t_real])
            probs = torch.stack(probs)
            if dp > 1:
                from videoitg_tpu_torch.parallel.mesh import gather_dp

                # [dp * groups, T] in rank order -> question order g dp + r
                probs = gather_dp(probs, self.mesh).reshape(dp, -1, enc.t_real)
                probs = probs.transpose(0, 1).reshape(-1, enc.t_real)
            probs = probs.cpu().numpy()
            return [probs[i] for i in range(n)]

    def select_many(self, frames, sampled_frames: Sequence[int], instructions: Sequence[str],
                    video_path: str = "",
                    doc_ids: Optional[Sequence[object]] = None) -> List[SelectionResult]:
        """Score many questions against ONE video, encoding it once."""
        if doc_ids is None:
            doc_ids = [None] * len(instructions)
        enc = self.encode_video(frames)
        out = []
        for instr, doc_id, sc in zip(instructions, doc_ids, self.score_encoded(enc, instructions)):
            index, logits = self.rank_frames(sc, sampled_frames)
            out.append(SelectionResult(
                index=index, logits=logits, num_frames=1, contexts=instr,
                video_path=video_path, doc_id=doc_id,
                sampled_frames=list(sampled_frames), raw_scores=sc))
        return out

    @torch.inference_mode()
    def score_frames(self, videos: Sequence, instructions: Sequence[str]) -> List[np.ndarray]:
        """Score raw decoded frames: videos are [T_i, H, W, 3] uint8, YUVFrames
        or PreprocessedVideo. All videos of one call share a bucket and hw
        (callers group by length). Returns [T_i] fp32 sigmoid scores each."""
        if len(videos) != len(instructions):
            raise ValueError(f"{len(videos)} videos for {len(instructions)} instructions")
        t_reals = [v.shape[0] for v in videos]
        t_bucket = frame_bucket(max(t_reals), self.buckets)
        hws = {inference_hw(self.cfg.projector, t, self.cfg.vision.num_patches_per_side)
               for t in t_reals}
        if len(hws) != 1:
            raise ValueError(f"videos in one batch must share hw (got {hws}); "
                             "group by frame count")
        hw = hws.pop()
        b_real, dp = len(videos), self._dp()
        if dp > 1:
            from videoitg_tpu_torch.parallel.mesh import dp_share

            # The batch splits over dp: a partial batch is padded by
            # repeating the last video, whose extra scores are dropped.
            pad = -b_real % dp
            videos = list(videos) + [videos[-1]] * pad
            instructions = list(instructions) + [instructions[-1]] * pad
            share = dp_share(len(videos), self.mesh)
            videos, instructions = videos[share], instructions[share]
        t_mine = [v.shape[0] for v in videos]
        with self.timer.stage("preprocess"):
            pix = torch.stack([self._preprocess(v, t_bucket) for v in videos])
            ids, text_valid = self._tokenize(instructions)
        batch = GroundingBatch(frames=pix, frame_valid=self._frame_valid(t_mine, t_bucket),
                               text_ids=ids, text_valid=text_valid)
        chunk = self.vision_chunk if len(videos) * t_bucket > self.vision_chunk else 0
        with self.timer.stage("score"), self._mesh_ctx():
            logits = grounding_logits(self.model, batch, self.cfg, hw=hw,
                                      use_flash=self.use_flash, vision_chunk=chunk,
                                      act8=self.act8, lm_splash=self.lm_splash)
            probs = torch.sigmoid(logits.float())  # sigmoid(-inf) = 0
            if dp > 1:
                from videoitg_tpu_torch.parallel.mesh import gather_dp

                probs = gather_dp(probs, self.mesh)
            probs = probs.cpu().numpy()
        return [probs[i, :t] for i, t in enumerate(t_reals[:b_real])]

    def rank_frames(self, scores: np.ndarray,
                    sampled_frames: Sequence[int]) -> Tuple[List[int], List[float]]:
        """Score-descending ranking, stable on ties (torch.sort semantics)."""
        order = np.argsort(-scores, kind="stable")
        index = [int(sampled_frames[i]) for i in order]
        logits = [round(float(scores[i]), 2) for i in order]
        return index, logits

    def select(self, frames, sampled_frames: Sequence[int], instruction: str,
               video_path: str = "", doc_id: Optional[object] = None) -> SelectionResult:
        """Score one decoded video and build the reference-contract result."""
        scores = self.score_frames([frames], [instruction])[0]
        index, logits = self.rank_frames(scores, sampled_frames)
        return SelectionResult(
            index=index, logits=logits,
            # Reference quirk: it stores the number of video tensors (always 1).
            num_frames=1, contexts=instruction, video_path=video_path, doc_id=doc_id,
            sampled_frames=list(sampled_frames), raw_scores=scores)

    def select_from_file(self, video_path: str, instruction: str,
                         doc_id: Optional[object] = None,
                         sampling: str = "eval") -> SelectionResult:
        """Decode (in-tree libav reader) + score a video file."""
        from videoitg_tpu_torch.data.video import read_video_frames

        with self.timer.stage("decode"):
            frames, sampled = read_video_frames(
                video_path, num_frames=self.num_frames, target_fps=self.target_fps,
                sampling=sampling, pix_fmt="yuv420" if self.transfer == "yuv420" else "rgb")
        return self.select(frames, sampled, instruction, video_path=video_path, doc_id=doc_id)
