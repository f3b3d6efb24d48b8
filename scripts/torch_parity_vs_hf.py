"""Real-checkpoint Top-K parity harness: the PyTorch port vs HF transformers.

The port's counterpart of scripts/parity_vs_torch.py. It loads ONE
HF-format VideoITG checkpoint directory into both sides:

* the oracle: the reference inference semantics rebuilt from HF
  transformers modules on the CPU in fp32 (SigLIP hidden_states[-2] ->
  seq_mlp bilinear pool + MLP -> image-first splice -> Qwen2 with
  bidirectional attention -> per-frame mean-pool -> out_proj -> sigmoid);
* the port: videoitg_tpu_torch.checkpoint.load_hf_state_dict ->
  convert_grounding_checkpoint -> SelectionEngine, in fp32.

Both get the same decoded frames (the infer-path frame-index rounding) and
the same token ids (the checkpoint's tokenizer through AutoTokenizer).
Checks: Top-K selected-index equality after the downstream contract's
"first k, then ascending", and score equality at the 2 decimals that
results.jsonl keeps. It imports nothing of JAX or the JAX package.

    python scripts/torch_parity_vs_hf.py --checkpoint /ckpts/VideoITG-8B \\
        --video clip.mp4 --prompt "Find the frames where the rocket launches."

The port runs on the card unless `--cpu` is given. `--selftest` proves the
harness end to end without weights: it synthesizes a tiny full-layout
checkpoint from HF modules (written by the port's safetensors codec, with a
tokenizer.json that AutoTokenizer loads) and a test video, and runs the path
real weights will take; `--selftest-geometry 8b` does so at VideoITG-8B's
widths with 2 LM and 3 tower layers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# transformers imports its TensorFlow and Flax backends (and jax with them)
# where they are installed unless told not to; the oracle is torch alone.
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


# --------------------------------------------------------------------------
# the HF transformers oracle
# --------------------------------------------------------------------------


def preprocess_frames_reference(frames: np.ndarray, out_size: int = 384) -> np.ndarray:
    """Pure-PIL SiglipImageProcessor semantics: bicubic resize, rescale,
    normalise; NHWC float32."""
    from PIL import Image

    out = np.empty((frames.shape[0], out_size, out_size, 3), dtype=np.float32)
    for i, frame in enumerate(frames):
        img = Image.fromarray(frame).resize((out_size, out_size), Image.BICUBIC)
        out[i] = np.asarray(img, dtype=np.float32)
    mean = np.asarray(SIGLIP_MEAN, dtype=np.float32) * 255.0
    std = np.asarray(SIGLIP_STD, dtype=np.float32) * 255.0
    return (out - mean) / std


def _tensor(v):
    import torch

    return torch.as_tensor(v).float()


def _hf_vision_config(cfg, **kwargs):
    from transformers import SiglipVisionConfig

    return SiglipVisionConfig(
        **kwargs,
        hidden_size=cfg.vision.hidden_size,
        intermediate_size=cfg.vision.intermediate_size,
        num_hidden_layers=cfg.vision.num_layers,
        num_attention_heads=cfg.vision.num_heads,
        image_size=cfg.vision.image_size,
        patch_size=cfg.vision.patch_size,
        layer_norm_eps=cfg.vision.layer_norm_eps,
        hidden_act="gelu_pytorch_tanh",
    )


def _hf_lm_config(cfg, **kwargs):
    from transformers import Qwen2Config

    return Qwen2Config(
        **kwargs,
        vocab_size=cfg.lm.vocab_size,
        hidden_size=cfg.lm.hidden_size,
        intermediate_size=cfg.lm.intermediate_size,
        num_hidden_layers=cfg.lm.num_layers,
        num_attention_heads=cfg.lm.num_heads,
        num_key_value_heads=cfg.lm.num_kv_heads,
        head_dim=cfg.lm.head_dim,
        rms_norm_eps=cfg.lm.rms_norm_eps,
        rope_theta=cfg.lm.rope_theta,
    )


def build_torch_stack(sd, cfg, attn: str = "eager"):
    """(vision_model, qwen2_model) HF modules loaded from the checkpoint.

    attn="eager" materialises [H, S, S] weights (exact, O(S^2) memory);
    attn="sdpa" runs torch's flash CPU kernel non-causally (O(S) memory), as
    the reference's flash-attn does with is_causal=False.
    """
    from transformers import Qwen2Model, SiglipVisionModel

    vision = SiglipVisionModel(_hf_vision_config(cfg, attn_implementation=attn)).eval()
    prefix = "model.vision_tower.vision_tower."
    vsd = {k[len(prefix):]: _tensor(sd[k]) for k in sd if k.startswith(prefix)}
    missing, unexpected = vision.load_state_dict(vsd, strict=False)
    # The features are hidden_states[-2]: the attention-pool head (and the
    # post-LN) may be absent.
    real_missing = [k for k in missing if ".head." not in k and "post_layernorm" not in k]
    assert not real_missing and not unexpected, (real_missing, unexpected)

    lm = Qwen2Model(_hf_lm_config(cfg, attn_implementation=attn, use_cache=False)).eval()
    lsd = {k[len("model."):]: _tensor(sd[k]) for k in sd
           if k.startswith("model.") and not k.startswith(("model.vision_tower.",
                                                           "model.mm_projector."))}
    lm.load_state_dict(lsd, strict=True)
    if attn == "sdpa":
        # Bidirectional attention: no mask tensor at all and a non-causal
        # flag per layer.
        for layer in lm.layers:
            layer.self_attn.is_causal = False
    return vision, lm


def torch_seq_mlp(sd, feats, hw: int):
    """seq_mlp projector semantics: bilinear pool, then Linear/GELU/Linear."""
    import torch.nn.functional as F

    t, p, c = feats.shape
    ori = int(math.isqrt(p))
    if hw < ori:
        x = feats.view(t, ori, ori, c).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(hw, hw), mode="bilinear", align_corners=False)
        x = x.permute(0, 2, 3, 1).reshape(t, hw * hw, c)
    else:
        x = feats
    w1, b1, w2, b2 = (_tensor(sd[f"model.mm_projector.out_projection.{i}.{leaf}"])
                      for i, leaf in ((0, "weight"), (0, "bias"), (2, "weight"), (2, "bias")))
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def torch_grounding_scores(sd, cfg, frames_u8: np.ndarray, text_ids: list,
                           attn: str = "eager") -> np.ndarray:
    """Reference-semantics sigmoid scores [T] for one video (fp32 CPU)."""
    import contextlib

    import torch

    vision, lm = build_torch_stack(sd, cfg, attn=attn)
    pixels = preprocess_frames_reference(frames_u8, out_size=cfg.vision.image_size)
    pixels = torch.from_numpy(pixels.transpose(0, 3, 1, 2))  # NCHW

    @contextlib.contextmanager
    def no_causal_mask():
        # sdpa: keep Qwen2Model from making a causal mask, so SDPA gets
        # mask=None with is_causal=False.
        import transformers.models.qwen2.modeling_qwen2 as qm

        orig = qm.create_causal_mask
        qm.create_causal_mask = lambda **kw: None
        try:
            yield
        finally:
            qm.create_causal_mask = orig

    with torch.no_grad():
        feats = vision(pixels, output_hidden_states=True).hidden_states[-2]
        t = feats.shape[0]
        ori = cfg.vision.num_patches_per_side
        hw = min(int(math.floor(math.sqrt(cfg.projector.vision_token_num / t))), ori)
        img = torch_seq_mlp(sd, feats, hw).reshape(1, t * hw * hw, -1)
        embed_w = _tensor(sd["model.embed_tokens.weight"])
        txt = embed_w[torch.as_tensor(text_ids, dtype=torch.long)][None]
        x = torch.cat([img, txt], dim=1)  # image-first splice
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.long)[None]
        if attn == "sdpa":
            with no_causal_mask():
                hidden = lm(inputs_embeds=x, attention_mask=None,
                            position_ids=positions).last_hidden_state
        else:
            full_mask = torch.zeros((1, 1, s, s))  # bidirectional
            hidden = lm(inputs_embeds=x, attention_mask=full_mask,
                        position_ids=positions).last_hidden_state
        frame_hidden = hidden[:, : t * hw * hw, :].reshape(1, t, hw * hw, -1).mean(2)
        w, b = _tensor(sd["out_proj.weight"]), _tensor(sd["out_proj.bias"])
        logits = (frame_hidden @ w.T + b)[0, :, 0]
        return torch.sigmoid(logits.float()).numpy()


# --------------------------------------------------------------------------
# the harness
# --------------------------------------------------------------------------


def topk_contract(index_desc: list, k: int) -> list:
    """First k score-descending ids, ascending (the downstream contract)."""
    return sorted(index_desc[:k])


def run_parity(checkpoint: str, video: str, prompt: str, num_frames: int, target_fps: float,
               topks, out_json: str | None = None, use_flash: bool = False,
               oracle_attn: str = "eager", device: str = "cuda") -> dict:
    import torch
    from transformers import AutoTokenizer

    from videoitg_tpu_torch.checkpoint import (convert_grounding_checkpoint,
                                               load_hf_state_dict, read_config)
    from videoitg_tpu_torch.data.tokenizer import grounding_text_ids
    from videoitg_tpu_torch.data.video import read_video_frames
    from videoitg_tpu_torch.engine import SelectionEngine

    cfg = read_config(checkpoint)
    tokenizer = AutoTokenizer.from_pretrained(checkpoint, use_fast=True)
    sd = load_hf_state_dict(checkpoint)

    # One decode feeds both sides.
    frames, sampled = read_video_frames(video, num_frames=num_frames, target_fps=target_fps,
                                        sampling="infer")
    text_ids = grounding_text_ids(prompt, tokenizer, cfg.max_text_len)
    print(f"[parity] {len(sampled)} frames, {len(text_ids)} text tokens, video={video}, "
          f"device={device}, use_flash={use_flash}, oracle={oracle_attn}")

    scores_t = torch_grounding_scores(sd, cfg, frames, text_ids, attn=oracle_attn)

    model = convert_grounding_checkpoint(sd, cfg, device=device, dtype=torch.float32)
    engine = SelectionEngine(model, cfg, tokenizer, device=device, dtype=torch.float32,
                             use_flash=use_flash, num_frames=num_frames, target_fps=target_fps,
                             buckets=(len(sampled),))
    res = engine.select(frames, sampled, prompt, video_path=video)
    scores_p = res.raw_scores

    order_t = np.argsort(-scores_t, kind="stable")
    index_t = [int(sampled[i]) for i in order_t]
    report = {
        "video": video, "checkpoint": checkpoint, "num_frames": len(sampled),
        "device": device,
        "max_abs_score_diff": float(np.abs(scores_p - scores_t).max()),
        "scores_2dp_equal": bool(np.array_equal(np.round(scores_p, 2), np.round(scores_t, 2))),
    }
    ok = report["scores_2dp_equal"]
    for k in topks:
        k_eff = min(k, len(sampled))
        same = topk_contract(res.index, k_eff) == topk_contract(index_t, k_eff)
        report[f"top{k}_index_equal"] = bool(same)
        ok = ok and same
    report["pass"] = bool(ok)
    print(json.dumps(report, indent=2))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


# --------------------------------------------------------------------------
# selftest: a checkpoint authored by HF modules, and a video
# --------------------------------------------------------------------------


def synthesize_checkpoint(out_dir: str, cfg=None, seed: int = 0) -> str:
    """Write a tiny reference-layout EagleQwenG checkpoint (HF-module
    weights through the port's safetensors codec, and a fast tokenizer)."""
    import torch
    from transformers import Qwen2Model, SiglipVisionModel

    from videoitg_tpu_torch.checkpoint import CONFIG_NAME, save_safetensors
    from videoitg_tpu_torch.config import GroundingConfig

    cfg = cfg or GroundingConfig.tiny()
    os.makedirs(out_dir, exist_ok=True)
    torch.manual_seed(seed)
    vision = SiglipVisionModel(_hf_vision_config(cfg)).eval()
    lm = Qwen2Model(_hf_lm_config(cfg)).eval()

    sd = {"model." + k: v for k, v in lm.state_dict().items()}
    for k, v in vision.state_dict().items():
        if ".head." in k or "post_layernorm" in k:
            continue  # the grounding checkpoint's tower stops before them
        sd["model.vision_tower.vision_tower." + k] = v
    g = torch.Generator().manual_seed(seed + 1)
    d_in, d_out = cfg.projector.input_dim, cfg.projector.output_dim
    sd["model.mm_projector.out_projection.0.weight"] = (
        torch.randn(d_out, d_in, generator=g) * d_in ** -0.5)
    sd["model.mm_projector.out_projection.0.bias"] = torch.zeros(d_out)
    sd["model.mm_projector.out_projection.2.weight"] = (
        torch.randn(d_out, d_out, generator=g) * d_out ** -0.5)
    sd["model.mm_projector.out_projection.2.bias"] = torch.zeros(d_out)
    sd["out_proj.weight"] = (torch.randn(1, cfg.lm.hidden_size, generator=g)
                             * cfg.lm.hidden_size ** -0.5)
    sd["out_proj.bias"] = torch.zeros(1)
    save_safetensors(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
        f.write(cfg.to_json())

    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ("find the frames where rocket launches what happens when color "
             "changes a is of to in and <unk>").split()
    vocab = {w: i + 1 for i, w in enumerate(words)}
    vocab["<unk>"] = 0
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return out_dir


def selftest(tmp_dir: str, device: str = "cuda") -> dict:
    from videoitg_tpu_torch.data.video import write_test_video

    ckpt = synthesize_checkpoint(os.path.join(tmp_dir, "ckpt"))
    video = write_test_video(os.path.join(tmp_dir, "vid.mp4"), 64, 48, 40, 10, 8)
    report = run_parity(ckpt, video, "find the frames where the rocket launches", num_frames=8,
                        target_fps=2.0, topks=(3, 8),
                        out_json=os.path.join(tmp_dir, "parity.json"), device=device)
    if not report["pass"]:
        raise SystemExit("selftest FAILED")
    print("[parity] selftest PASS")
    return report


def selftest_8b(tmp_dir: str, frames: int = 64, budget: int = 16384, flash_budget: int = 1024,
                device: str = "cuda") -> dict:
    """The selftest at VideoITG-8B's widths (hidden 3584, GQA 28q/4kv,
    head_dim 128, tower 1152 / 16 heads / 729 patches) with 2 LM and 3 tower
    layers, in two arms on the same weights:

    * oracle: seq_mlp budget `budget` at `frames` frames (at 64 frames the
      splice holds >= the 12.9k tokens of a 512-frame request), the port on
      its plain attention, the oracle on SDPA non-causally;
    * flash: the port's attention through the kernel wrappers
      (`use_flash=True`) at budget `flash_budget`. Their plain versions
      serve on the CPU; on the card the kernels take bf16 only, so this arm
      runs on the CPU alone.
    """
    from videoitg_tpu_torch.config import GroundingConfig
    from videoitg_tpu_torch.data.video import write_test_video

    video = write_test_video(os.path.join(tmp_dir, "vid8b.mp4"), 96, 64, 2 * frames, 10, 12)
    prompt = "find the frames where the rocket launches"
    ckpt = synthesize_checkpoint(os.path.join(tmp_dir, "ckpt8b"),
                                 cfg=GroundingConfig.videoitg_8b_shallow())
    arms = [("oracle", budget, False)] + ([("flash", flash_budget, True)]
                                          if device == "cpu" else [])
    reports = {}
    for arm, arm_budget, use_flash in arms:
        # The same weights; only the seq_mlp budget of the config differs.
        cfg = GroundingConfig.videoitg_8b_shallow(vision_token_num=arm_budget)
        with open(os.path.join(ckpt, "videoitg_tpu_config.json"), "w") as f:
            f.write(cfg.to_json())
        report = run_parity(ckpt, video, prompt, num_frames=frames, target_fps=4.0,
                            topks=(8, 32), use_flash=use_flash, oracle_attn="sdpa",
                            out_json=os.path.join(tmp_dir, f"parity_8b_{arm}.json"),
                            device=device)
        if not report["pass"]:
            raise SystemExit(f"selftest-8b {arm} arm FAILED")
        print(f"[parity] selftest-8b {arm} arm PASS "
              f"(max_abs_score_diff={report['max_abs_score_diff']:.2e})")
        reports[arm] = report
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", help="HF-format VideoITG checkpoint dir")
    p.add_argument("--video", help="video file")
    p.add_argument("--prompt", default="Describe the key moment.", help="instruction to ground")
    p.add_argument("--num-frames", type=int, default=512)
    p.add_argument("--target-fps", type=float, default=2.0)
    p.add_argument("--topk", type=int, nargs="+", default=[8, 32])
    p.add_argument("--out-json", default=None)
    p.add_argument("--cpu", action="store_true", help="run the port on the CPU")
    p.add_argument("--selftest", action="store_true",
                   help="synthesize a tiny checkpoint + video and verify")
    p.add_argument("--selftest-geometry", choices=["tiny", "8b"], default="tiny",
                   help="8b = VideoITG-8B's widths and heads with few layers")
    p.add_argument("--selftest-frames", type=int, default=64)
    p.add_argument("--selftest-budget", type=int, default=16384,
                   help="seq_mlp vision_token_num of the 8b oracle arm")
    args = p.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        p.error("no CUDA device found; pass --cpu to run the port on the CPU")
    device = "cpu" if args.cpu else "cuda"
    if args.selftest:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            if args.selftest_geometry == "8b":
                selftest_8b(d, frames=args.selftest_frames, budget=args.selftest_budget,
                            device=device)
            else:
                selftest(d, device=device)
        return 0
    if not args.checkpoint or not args.video:
        p.error("--checkpoint and --video required (or --selftest)")
    report = run_parity(args.checkpoint, args.video, args.prompt, args.num_frames,
                        args.target_fps, args.topk, out_json=args.out_json, device=device)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
