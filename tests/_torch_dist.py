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


# ---- training on a mesh (tests/test_torch_parallel_train*.py) ----


def train_cfg(objective="grounding", layers=4):
    """The port's preset("tiny") with `layers` LM layers; the causal VLM with
    tied embeddings for objective "vlm"."""
    import dataclasses

    from videoitg_tpu_torch.config import GroundingConfig

    cfg = GroundingConfig.tiny()
    lm = dataclasses.replace(cfg.lm, num_layers=layers)
    if objective == "vlm":
        lm = dataclasses.replace(lm, causal=True, tie_word_embeddings=True)
    return dataclasses.replace(cfg, lm=lm)


def grounding_samples(cfg, seed, form, b=4, t_reals=(4, 3, 2, 4), l_txt=(9, 5, 3, 7),
                      positive_rows=None):
    """[(frames or features, text ids, labels)] from a numpy seed, for either
    package's GroundingSample. Labels may be positive only in
    `positive_rows` (default: every row; row 0's first frame always is)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        t = t_reals[i % len(t_reals)]
        if form == "frames":
            fr = rng.integers(0, 256, (t, cfg.vision.image_size, cfg.vision.image_size, 3),
                              dtype=np.uint8)
        else:
            fr = rng.standard_normal((t, cfg.vision.num_patches, cfg.vision.hidden_size)
                                     ).astype(np.float32)
        ids = rng.integers(1, cfg.lm.vocab_size, l_txt[i % len(l_txt)]).tolist()
        labels = (rng.random(t) < 0.4).astype(np.float32)
        if positive_rows is not None and i not in positive_rows:
            labels[:] = 0.0
        if i == 0:
            labels[0] = 1.0
        out.append((fr, ids, labels))
    return out


def vlm_samples(seed, b=4, t=(2, 1, 2, 2), size=56):
    """[(frames, pre ids, post ids, post labels)] for either package's
    VLMSample."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        frames = rng.integers(0, 256, size=(t[i % len(t)], size, size, 3), dtype=np.uint8)
        n_pre, n_post = 2 + i % 2, 5 - i % 3
        post = rng.integers(1, 500, n_post).tolist()
        labels = [-100] * (n_post // 2) + post[n_post // 2:]
        out.append((frames, rng.integers(1, 500, n_pre).tolist(), post, labels))
    return out


T_BUCKET = 4
HW = 2
VLM_PAD = dict(max_pre=4, max_post=6)


def port_batch(cfg, spec, t_bucket=T_BUCKET):
    """The port's batch of a layout's batch spec (objective, seed, form, kw)."""
    objective, seed, form, kw = spec
    if objective == "vlm":
        from videoitg_tpu_torch.train.vlm_sft import VLMSample, collate_vlm

        return collate_vlm([VLMSample(*x) for x in vlm_samples(seed, **kw)], t_bucket=2,
                           cfg=cfg, dtype=torch.float32, **VLM_PAD)
    from videoitg_tpu_torch.train.collate import collate_grounding
    from videoitg_tpu_torch.train.dataset import GroundingSample

    samples = [GroundingSample(fr, ids, lab, "v") for fr, ids, lab
               in grounding_samples(cfg, seed, form, **kw)]
    return collate_grounding(samples, t_bucket, cfg, dtype=torch.float32)


# Optimizer settings shared with the JAX reference: lr 0 at update 0, then
# constant; clipping active (the norms exceed it).
TRAIN_OPT = dict(learning_rate=1e-4, out_proj_lr=1e-3, total_steps=4, schedule="constant",
                 warmup_ratio=0.0, max_grad_norm=0.5)


def train_layout(mesh, model, cfg, layout, steps=2):
    """`steps` calls of run_step(mesh=...) on this rank's slice of `model`:
    {"shape", "coords", "metrics": [per step], "leaves": this rank's trainable
    leaves after them, "grads": the first step's gradients (after the dp
    sum), "frozen": names of leaves that moved but do not train}."""
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.mesh import TP_AXIS, mesh_coords, mesh_shape
    from videoitg_tpu_torch.train import lora, optimizer, train_step, vlm_sft

    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    tp_group = mesh.get_group(TP_AXIS) if shape.get(TP_AXIS, 1) > 1 else None
    specs = sharding.grounding_param_specs(pp=shape.get("pp", 1) > 1)
    local = sharding.shard_model(model, specs, shape, coords, tp_group=tp_group)
    make_opt = (lora.make_lora_optimizer if layout["opt"] == "lora"
                else optimizer.make_grounding_optimizer)
    tx = make_opt(local, **TRAIN_OPT)
    seen = []
    apply = tx.apply

    def recording_apply(grads, norms=None):
        if not seen:
            seen.extend(g.detach().clone() for g in grads)
        apply(grads, norms=norms)
    tx.apply = recording_apply
    objective = layout["batch"][0]
    make = vlm_sft.make_vlm_train_step if objective == "vlm" else train_step.make_train_step
    step_fn = make(cfg, tx, hw=layout.get("hw", HW) if objective != "vlm" else 1,
                   use_flash=layout.get("use_flash", False), remat=True)
    start = {n: t.detach().clone() for n, t in local.state_dict().items()}
    state = train_step.create_train_state(local, tx)
    batch = port_batch(cfg, layout["batch"], layout.get("t_bucket", T_BUCKET))
    metrics = []
    for _ in range(steps):
        state, m = train_step.run_step(step_fn, state, batch, mesh=mesh,
                                       microbatches=layout.get("microbatches"))
        metrics.append({k: float(v) for k, v in m.items()})
    names = tx.trainable_names()
    sd = local.state_dict()
    return {"shape": shape, "coords": coords, "metrics": metrics,
            "leaves": {n: sd[n].numpy() for n in names},
            "grads": {n: g.numpy() for n, g in zip(names, seen)},
            "frozen": sorted(n for n in sd if n not in names and not torch.equal(sd[n], start[n]))}


def train_job(tree_paths, layouts):
    """Every layout of `layouts` ({"name", "mesh": make_mesh kwargs, "ranks",
    "tree": key of tree_paths, "opt", "batch", "use_flash", "microbatches",
    "hw", "t_bucket"})
    on the ranks it names: {name: train_layout(...)}."""
    from videoitg_tpu_torch.checkpoint import params_from_numpy
    from videoitg_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for layout in layouts:
        mesh = make_mesh(ranks=layout.get("ranks"), **layout["mesh"])
        if not _in(mesh):
            continue
        cfg = train_cfg(layout["batch"][0])
        with open(tree_paths[layout["tree"]], "rb") as f:
            model = params_from_numpy(pickle.load(f), cfg)
        out[layout["name"]] = train_layout(mesh, model, cfg, layout)
    return out


def ring_train_inputs(seed, n, b=1, hq=4, hkv=2, s=128, d=16):
    """q, k, v and a key mask whose last block (of a ring of n) holds no
    valid key: 15% of the other keys masked too."""
    rng = np.random.default_rng(seed)
    q, k, v, _ = ring_inputs(seed, b, hq, hkv, s, d)
    valid = np.broadcast_to(rng.random(s) > 0.15, (b, s)).copy()
    valid[:, s - s // n:] = False
    return q, k, v, valid


def _ring_loss_grads(fn, q, k, v, valid):
    """(out, dq, dk, dv) of sum((out * valid rows) ** 2)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt)
    rows = torch.from_numpy(valid)[:, None, :, None].float()
    ((out.float() * rows) ** 2).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def ring_train_job():
    """`ring_attention_train` at sp 2 (ranks 0, 1) and sp 4: output and
    gradients; the serving flash ring's output on the same inputs; and
    `mha(use_flash="train")` under an sp 4 attention mesh."""
    from videoitg_tpu_torch.ops.attention import mha
    from videoitg_tpu_torch.parallel.context import attention_mesh
    from videoitg_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_train

    out = {}
    for n in (2, 4):
        mesh = sub_mesh(("sp",), (n,), list(range(n)))
        if not _in(mesh):
            continue
        q, k, v, valid = ring_train_inputs(n, n)
        vt = torch.from_numpy(valid)
        out[f"sp{n}"] = _ring_loss_grads(
            lambda a, b, c: ring_attention_train(a, b, c, valid=vt, mesh=mesh), q, k, v, valid)
        out[f"sp{n}-serving"] = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                               valid=vt, mesh=mesh, block_impl="flash").numpy()
        if n == 4:
            with attention_mesh(mesh, sp_axis="sp"):
                out["mha-sp4"] = _ring_loss_grads(
                    lambda a, b, c: mha(a, b, c, valid=vt, use_flash="train"), q, k, v, valid)
    return out


def pipeline_grad_job(tree_path, cfg_layers=4):
    """The decoder pipeline under autograd at pp 2 (ranks 0, 1; 1 and 2
    microbatches) and pp 2 x dp 2: the hidden states, the gradient of the
    input and of every stage's leaves, for the loss sum(h * r)."""
    from videoitg_tpu_torch.checkpoint import params_from_numpy
    from videoitg_tpu_torch.models.qwen2 import qwen2_hidden_states
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.context import pipeline_mesh
    from videoitg_tpu_torch.parallel.mesh import (dp_share, gather_dp, make_mesh, mesh_coords,
                                                  mesh_shape)

    cfg = train_cfg(layers=cfg_layers)
    with open(tree_path, "rb") as f:
        model = params_from_numpy(pickle.load(f), cfg)
    x, pos, valid = (torch.from_numpy(a) for a in pipeline_inputs(0))
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(x.shape).astype(np.float32))
    specs = sharding.grounding_param_specs(pp=True)
    out = {}
    for name, kw, ranks, ms in (("pp2", dict(pp=2), [0, 1], (1, 2)),
                                ("pp2-dp2", dict(pp=2, dp=2), None, (None,))):
        mesh = make_mesh(ranks=ranks, **kw)
        if not _in(mesh):
            continue
        local = sharding.shard_model(model, specs, mesh_shape(mesh), mesh_coords(mesh))
        for p in local.lm.layers.parameters():
            p.requires_grad_()
        share = dp_share(x.shape[0], mesh)
        for m in ms:
            xi = x[share].clone().requires_grad_()
            with pipeline_mesh(mesh, microbatches=m):
                h = qwen2_hidden_states(local.lm, xi, pos[share], valid[share], cfg.lm,
                                        remat=True)
            (h * r[share]).sum().backward()
            first = local.lm.pp_layers[0]
            grads = {}
            for name_, p in local.lm.layers.named_parameters():
                i, rest = name_.split(".", 1)
                grads[f"lm.layers.{first + int(i)}.{rest}"] = p.grad.numpy().copy()
                p.grad = None
            out[f"{name}-m{m}"] = {"h": gather_dp(h.detach(), mesh).numpy(),
                                   "dx": gather_dp(xi.grad, mesh).numpy(), "grads": grads}
    return out


def checkpoint_job(tree_path, out_dir):
    """A dp2 x tp2 full finetune: one step, a checkpoint, a second step
    ("straight"); the checkpoint restored into a fresh sharded model on the
    same layout, then the second step ("resumed"); on rank 0 also restored
    into a whole model with no mesh, then the second step ("whole")."""
    import torch.distributed as dist

    from videoitg_tpu_torch.checkpoint import params_from_numpy
    from videoitg_tpu_torch.parallel import sharding
    from videoitg_tpu_torch.parallel.mesh import make_mesh, mesh_coords, mesh_shape
    from videoitg_tpu_torch.train import optimizer, train_step
    from videoitg_tpu_torch.train.checkpointing import TrainCheckpointer

    cfg = train_cfg()
    mesh = make_mesh(dp=2, tp=2)
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)

    def fresh(on_mesh):
        with open(tree_path, "rb") as f:
            model = params_from_numpy(pickle.load(f), cfg)
        if on_mesh:
            model = sharding.shard_model(model, sharding.grounding_param_specs(), shape, coords,
                                         tp_group=mesh.get_group("tp"))
        tx = optimizer.make_grounding_optimizer(model, **TRAIN_OPT)
        return (train_step.create_train_state(model, tx),
                train_step.make_train_step(cfg, tx, hw=HW, remat=True))

    b0, b1 = (port_batch(cfg, ("grounding", seed, "features", {})) for seed in (11, 12))

    def leaves(state):
        sd = state.model.state_dict()
        return {n: sd[n].numpy().copy() for n in state.optimizer.trainable_names()}

    def moments(state):
        return {n: {k: v.numpy().copy() for k, v in st.items() if k != "step"}
                for n, st in zip(state.optimizer.trainable_names(),
                                 (state.optimizer.optimizer.state[p]
                                  for p in state.optimizer.params))}

    state, step_fn = fresh(True)
    for b in (b0, b0):  # the first update has lr 0: take two before saving
        state, _ = train_step.run_step(step_fn, state, b, mesh=mesh)
    assert TrainCheckpointer(out_dir, save_interval=1, mesh=mesh).maybe_save(2, state)
    saved_moments = moments(state)
    state, m = train_step.run_step(step_fn, state, b1, mesh=mesh)
    out = {"shape": shape, "coords": coords,
           "straight": (float(m["loss"]), float(m["grad_norm"]), leaves(state))}
    template, step_fn = fresh(True)
    step, restored = TrainCheckpointer(out_dir, mesh=mesh).restore_latest(template)
    out["restored_moments_equal"] = all(
        all(np.array_equal(v, moments(restored)[n][k]) for k, v in st.items())
        for n, st in saved_moments.items())
    restored, m = train_step.run_step(step_fn, restored, b1, mesh=mesh)
    out["resumed"] = (step, float(m["loss"]), float(m["grad_norm"]), leaves(restored))
    if dist.get_rank() == 0:
        template, step_fn = fresh(False)
        step, restored = TrainCheckpointer(out_dir).restore_latest(template)
        restored, m = train_step.run_step(step_fn, restored, b1)
        out["whole"] = (step, float(m["loss"]), float(m["grad_norm"]), leaves(restored))
        with open(os.path.join(out_dir, "checkpoints", "2", "state.pt"), "rb") as f:
            saved = torch.load(f, weights_only=True)
        out["saved_shapes"] = {n: tuple(t.shape) for n, t in saved["model"].items()}
    return out


def many_job(jobs):
    """Several jobs in one world, in order: {job name: its result}."""
    return {name: JOBS[name](**kwargs) for name, kwargs in jobs}


JOBS = {"ring": ring_job, "pipeline": pipeline_job, "engine": engine_job,
        "multihost": multihost_job, "adapter": adapter_job, "train": train_job,
        "ring_train": ring_train_job, "pipeline_grad": pipeline_grad_job,
        "checkpoint": checkpoint_job, "many": many_job}
