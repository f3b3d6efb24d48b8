"""Gloo worlds for the port's parallel tests: `run_world` spawns N ranks
with torch.multiprocessing (a file store in the test's tmp_path, one thread
a rank), runs one of the jobs below on every rank and returns each rank's
result. The jobs import torch, numpy and the port only (no JAX), so a rank
starts in a few seconds; the JAX references are computed in the test process.
"""

import os
import pickle
import tempfile

import numpy as np
import torch

# ---- the harness ----


def _rank_main(rank, world, tmp, job, kwargs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = JOBS[job](**kwargs)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()  # no rank leaves while another still talks to it
    finally:
        dist.destroy_process_group()


def run_world(world: int, job: str, tmp, **kwargs):
    """[result of rank r] for r in range(world); a rank's exception is raised
    here with its traceback."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, tmp, job, kwargs), nprocs=world,
                       start_method="spawn", join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def sub_mesh(axes, shape, ranks):
    """A DeviceMesh of `axes` over `ranks` (every rank of the world calls it)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.tensor(ranks).reshape(shape), mesh_dim_names=axes)


def _in(mesh):
    return mesh.get_coordinate() is not None


# ---- inputs shared with the test process (numpy seeds) ----


def ring_inputs(seed, b, hq, hkv, s, d, valid_below=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    valid = None if valid_below is None else np.broadcast_to(np.arange(s) < valid_below,
                                                             (b, s)).copy()
    return q, k, v, valid


# (name, n, seed, (b, hq, hkv, s, d), valid_below, causal, block_impl)
RING_CASES = [
    ("n4", 4, 0, (2, 4, 4, 64, 16), None, False, "einsum"),
    ("n4-causal", 4, 0, (2, 4, 4, 64, 16), None, True, "einsum"),
    ("n8", 8, 0, (2, 4, 4, 64, 16), None, False, "einsum"),
    ("mask-dead-rows", 4, 1, (1, 2, 2, 48, 8), 29, False, "einsum"),
    ("none-valid", 4, 1, (1, 2, 2, 48, 8), 0, False, "einsum"),
    ("flash-gqa-mask", 4, 3, (1, 4, 2, 64, 16), 41, False, "flash"),
    ("flash-dead-shard", 4, 1, (1, 2, 2, 48, 8), 29, False, "flash"),
    ("flash-none-valid", 4, 1, (1, 2, 2, 48, 8), 0, False, "flash"),
]


# ---- jobs ----


def ring_job():
    """Every RING_CASES case through the port's ring over gloo, plus the
    attention dispatch under an sp mesh of 8."""
    import torch.distributed as dist

    from videoitg_tpu_torch.ops.attention import mha
    from videoitg_tpu_torch.parallel.context import attention_mesh
    from videoitg_tpu_torch.parallel.mesh import make_mesh
    from videoitg_tpu_torch.parallel.ring_attention import ring_attention

    world = dist.get_world_size()
    meshes = {n: sub_mesh(("sp",), (n,), list(range(n))) for n in (4, 8) if n <= world}
    out = {}
    for name, n, seed, shape, below, causal, impl in RING_CASES:
        mesh = meshes[n]
        if not _in(mesh):
            continue
        q, k, v, valid = ring_inputs(seed, *shape, valid_below=below)
        got = ring_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             None if valid is None else torch.from_numpy(valid), mesh=mesh,
                             causal=causal, block_impl=impl)
        out[name] = got.numpy()
    mesh = make_mesh(dp=1, tp=1, sp=world)
    q, k, v, valid = ring_inputs(21, 2, 4, 2, 128, 16, valid_below=100)
    with attention_mesh(mesh):
        out["mha-sp"] = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            valid=torch.from_numpy(valid)).numpy()
    return out


def _model(tree_path, cfg_name="tiny", tier=None):
    from videoitg_tpu_torch.checkpoint import params_from_numpy
    from videoitg_tpu_torch.config import preset

    with open(tree_path, "rb") as f:
        tree = pickle.load(f)
    model = params_from_numpy(tree, preset(cfg_name))
    if tier is not None:
        from videoitg_tpu_torch.ops.quant import apply_quantization_tier

        apply_quantization_tier(model, tier)
    return model


def pipeline_inputs(seed, b=4, s=24, h=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    valid = np.ones((b, s), bool)
    valid[1, 17:] = False
    valid[3, 9:] = False
    return x, pos, valid


def pipeline_job(tree_path):
    """The decoder stack as a pipeline: pp=2 alone (ranks 0, 1) with 1, 2 and
    4 microbatches, and pp=2 x dp=2 (four ranks), the batch split over dp."""
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.models.qwen2 import qwen2_hidden_states
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.context import pipeline_mesh
    from videoitg_tpu_torch.parallel.mesh import (dp_share, gather_dp, make_mesh, mesh_coords,
                                                  mesh_shape)

    cfg = preset("tiny")
    model = _model(tree_path)
    x, pos, valid = (torch.from_numpy(a) for a in pipeline_inputs(0))
    specs = sharding.grounding_param_specs(pp=True)
    out = {}
    for name, kw, ranks in (("pp2", dict(pp=2), [0, 1]), ("pp2-dp2", dict(pp=2, dp=2), None)):
        mesh = make_mesh(ranks=ranks, **kw)
        if not _in(mesh):
            continue
        local = sharding.shard_model(model, specs, mesh_shape(mesh), mesh_coords(mesh))
        share = dp_share(x.shape[0], mesh)
        for m in ((1, 2, 4) if name == "pp2" else (None,)):
            with torch.inference_mode(), pipeline_mesh(mesh, microbatches=m):
                h = qwen2_hidden_states(local.lm, x[share], pos[share], valid[share], cfg.lm)
            out[f"{name}-m{m}"] = gather_dp(h, mesh).numpy()
    return out


def frames(seed, t, size=56):
    return np.random.default_rng(seed).integers(0, 256, (t, size, size, 3), dtype=np.uint8)


ENGINE_LAYOUTS = {  # name -> (make_mesh kwargs, ranks or None for the whole world)
    "dp2": (dict(dp=2, tp=1), [0, 1]),
    "tp2": (dict(dp=1, tp=2), [0, 1]),
    "sp2": (dict(dp=1, tp=1, sp=2), [0, 1]),
    "pp2": (dict(dp=1, tp=1, pp=2), [0, 1]),
    "dp2-tp2": (dict(dp=2, tp=2), None),
}
QUESTIONS = ["what happens next?", "a second, longer question", "third"]


def engine_calls(engine):
    """The engine's three entry points on fixed inputs: {call: raw scores}."""
    sel = engine.select(frames(0, 6), list(range(0, 60, 10)), QUESTIONS[0])
    many = engine.select_many(frames(1, 5), list(range(5)), QUESTIONS)
    batch = engine.score_frames([frames(2, 4), frames(3, 4), frames(4, 3)], QUESTIONS)
    return {"select": (sel.index, sel.raw_scores),
            "select_many": [(r.index, r.raw_scores) for r in many],
            "score_frames": batch}


# Row-parallel act8 linears held one by one (parallel/tensor.py's amax rule).
ROW_LINEARS = ("lm.layers.0.o", "lm.layers.1.down", "vision.layers.0.fc2")


def row_linear_input(n_in, m=6, seed=7):
    """[m, n_in] rows whose amax lies in the second half of the input axis
    on even rows and in the first on odd rows, so that each tp=2 rank's
    local amax differs from the row's."""
    x = np.random.default_rng(seed).standard_normal((m, n_in)).astype(np.float32)
    x[::2, n_in // 2:] *= 8
    x[1::2, :n_in // 2] *= 8
    return x


def engine_job(tree_path, tier_paths):
    """The engine in every ENGINE_LAYOUTS layout; each quantised tree of
    `tier_paths` ({tier: bridged JAX tree}) at tp=2, and act8 with no mesh
    too; the ROW_LINEARS of the act8 tree at tp=2; tp=4's ValueError."""
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.engine import SelectionEngine
    from videoitg_tpu_torch.parallel.mesh import make_mesh
    from videoitg_tpu_torch.utils.common import CharTokenizer

    cfg = preset("tiny")
    tok = CharTokenizer(cfg.lm.vocab_size)

    def engine(model, mesh=None):
        return SelectionEngine(model, cfg, tok, device="cpu", dtype=torch.float32,
                               use_flash=False, buckets=(4, 8), num_frames=8, mesh=mesh)

    from videoitg_tpu_torch.parallel import pipeline, ring_attention

    calls = {}

    def counted(mod, fn):
        inner = getattr(mod, fn)

        def wrapper(*a, **k):
            calls[fn] = calls.get(fn, 0) + 1
            return inner(*a, **k)
        setattr(mod, fn, wrapper)

    counted(ring_attention, "ring_attention")
    counted(pipeline, "pipeline_hidden_states")
    model = _model(tree_path)
    out = {}
    for name, (kw, ranks) in ENGINE_LAYOUTS.items():
        mesh = make_mesh(ranks=ranks, **kw)
        if _in(mesh):
            calls.clear()
            out[name] = engine_calls(engine(model, mesh))
            out[name]["calls"] = dict(calls)
    mesh = make_mesh(dp=1, tp=2, ranks=[0, 1])
    if _in(mesh):
        for tier, path in sorted(tier_paths.items()):
            quantized = _model(path)
            out[f"{tier}-tp2"] = engine_calls(engine(quantized, mesh))
            if tier == "act8":
                out["act8-tp1"] = engine_calls(engine(quantized))
                out.update(_row_linears(quantized, mesh))
    try:
        engine(model, make_mesh(dp=1, tp=4))
    except ValueError as e:
        out["tp4-error"] = str(e)
    return out


def _row_linears(model, mesh):
    """{"row-<name>": this tp rank's output of each ROW_LINEARS linear, its
    input the rank's half of `row_linear_input`}."""
    from videoitg_tpu_torch.models.common import linear
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.mesh import TP_AXIS, mesh_coords, mesh_shape

    local = sharding.shard_model(model, sharding.grounding_param_specs(), mesh_shape(mesh),
                                 mesh_coords(mesh), tp_group=mesh.get_group(TP_AXIS))
    r, out = mesh.get_local_rank(TP_AXIS), {}
    for name in ROW_LINEARS:
        x = row_linear_input(model.get_submodule(name).in_features)
        half = x.shape[1] // 2
        with torch.inference_mode():
            y = linear(local.get_submodule(name), torch.from_numpy(x[:, r * half:(r + 1) * half]))
        out[f"row-{name}"] = y.numpy()
    return out


def multihost_job():
    import torch.distributed as dist

    from videoitg_tpu_torch.eval import multihost

    multihost.barrier("start")
    got = multihost.gather_objects({"rank": dist.get_rank(), "text": "é" * dist.get_rank()})
    multihost.barrier("end")
    return {"multiprocess": multihost.is_multiprocess(), "gathered": got}


def adapter_job(data_root, docs, base):
    """The grounding adapter's rows with a mesh on each axis of 2, and with
    none, over the docs (ranks 0, 1)."""
    from videoitg_tpu_torch.eval.api import get_adapter, get_task
    from videoitg_tpu_torch.eval.harness import evaluate_task

    out = {}
    for arg in ("dp", "tp", "sp", "pp", None):
        adapter = get_adapter("videoitg")(device="cpu", data_root=data_root, **base,
                                          **({arg: 2} if arg else {}))
        with tempfile.TemporaryDirectory() as d:
            evaluate_task(adapter, get_task("videomme"), docs, d)
            with open(os.path.join(d, "results.rank0.jsonl")) as f:
                out[arg] = f.read()
    return out


JOBS = {"ring": ring_job, "pipeline": pipeline_job, "engine": engine_job,
        "multihost": multihost_job, "adapter": adapter_job}
