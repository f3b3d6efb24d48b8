"""Everything the benchmark takes from the program, videoitg_tpu_torch: the
model built through its own modules and loading path, its serving engine,
and the names its modules import, which the traced run rebinds to open the
benchmark's ranges around them. The program's sources are not changed."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

# (module under videoitg_tpu_torch.models, attribute) of the LM's attention
# entry, where the configuration's architecture module names none
LM_ATTENTION = ("qwen2", "mha")


def port_config(model: dict):
    """The port's `GroundingConfig`, read by the port's own reader, so that
    an LM family's keys are the port's to parse."""
    from videoitg_tpu_torch.config import GroundingConfig

    return GroundingConfig.from_json(json.dumps(model))


def build_engine(cfg: dict, state: Dict[str, torch.Tensor], device: torch.device,
                 tier: Optional[str] = None, kernels: Optional[dict] = None):
    """The port's `SelectionEngine` over the weights `state` (the port's
    state-dict names), in the configuration's tier or `tier`, with its act8
    kernel switches or `kernels`. The dense tensors are taken over, not
    copied; a quantised tier replaces them layer by layer."""
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.models.grounding import GroundingModel
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier
    from videoitg_tpu_torch.utils.common import CharTokenizer

    pcfg = port_config(cfg["model"])
    dtype = DTYPES[cfg["dtype"]]
    tier = cfg.get("tier") if tier is None else tier
    kernels = cfg["kernels"] if kernels is None else kernels
    model = GroundingModel(pcfg, device="meta", dtype=dtype)
    model.load_state_dict(state, strict=True, assign=True)
    if tier:
        apply_quantization_tier(model, tier)
    tok = CharTokenizer(pcfg.lm.vocab_size)
    return SelectionEngine(model, pcfg, tok, device=device, dtype=dtype,
                           qgemm=kernels["qgemm"], fused=kernels["fused"],
                           lm_splash=kernels["lm_splash"])


@dataclass
class Calls:
    """What the traced run records at the calls it wraps: each attention
    call's q, k and v shapes, and its key mask (read after the window, so
    that the window has no extra synchronisation)."""

    attention: Dict[str, List[Tuple[tuple, tuple, tuple, Optional[torch.Tensor]]]] = field(
        default_factory=dict)

    def attention_work(self, site: str):
        """(operations, bytes) of every call at `site`, pairs from the masks."""
        from benchmark.roofline import attention_work

        out = []
        for qs, ks, vs, valid in self.attention.get(site, []):
            b, hq, s, d = qs
            pairs = None
            if valid is not None:
                n = valid.sum(dim=-1).tolist()
                pairs = [x * x for x in n]
            out.append(attention_work(b, hq, ks[1], s, d, pairs=pairs, dv=vs[-1]))
        return out


def install_ranges(calls: Calls, lm_attention: Tuple[str, str] = LM_ATTENTION):
    """Rebind the names the port's modules call through, so that each call
    opens a `bench:<name>` range; the LM's attention entry is `lm_attention`
    (module under videoitg_tpu_torch.models, attribute), its range
    `bench:<module>.<attribute>`. Returns a function that puts them back."""
    from torch.profiler import record_function

    from videoitg_tpu_torch import engine as engine_mod
    from videoitg_tpu_torch.models import grounding as grounding_mod
    from videoitg_tpu_torch.models import siglip as siglip_mod

    lm_module, lm_attr = lm_attention
    lm_mod = importlib.import_module("videoitg_tpu_torch.models." + lm_module)

    undo = []

    def rebind(owner, attr, label, record=None):
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if record is not None:
                record(*args, **kwargs)
            with record_function("bench:" + label):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))

    def attention_recorder(site):
        seen: Dict[int, torch.Tensor] = {}

        def record(q, k=None, v=None, valid=None, *args, **kwargs):
            # an entry that is not called as attention(q, k, v) records nothing
            if not all(isinstance(t, torch.Tensor) and t.dim() == 4 for t in (q, k, v)):
                return
            if valid is not None:
                valid = seen.setdefault(id(valid), valid)
            calls.attention.setdefault(site, []).append(
                (tuple(q.shape), tuple(k.shape), tuple(v.shape), valid))
        return record

    rebind(engine_mod.SelectionEngine, "_preprocess", "preprocess")
    rebind(engine_mod, "vision_features", "tower")
    rebind(grounding_mod, "vision_features", "tower")
    rebind(engine_mod, "grounding_logits", "score")
    rebind(engine_mod.SelectionEngine, "score_encoded", "score")
    rebind(siglip_mod, "mha", "siglip.mha", attention_recorder("siglip.mha"))
    lm_site = f"{lm_module}.{lm_attr}"
    rebind(lm_mod, lm_attr, lm_site, attention_recorder(lm_site))

    def restore():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    return restore
