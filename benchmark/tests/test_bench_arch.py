"""A configuration's LM architecture found by name: the existing
configurations keep their weights, work counts, ranges and port
configuration bit for bit; and a configuration of another architecture,
added to a copy of the benchmark as new files alone, is decided, drawn,
counted and ranged through its own module."""

import ast
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from _tiny import TINY_MIX
from benchmark.harness import Run, run_cell
from benchmark.inputs import make_traffic
from benchmark.manifest import ROOT, Manifest, reference_module
from benchmark.port import Calls, build_engine, install_ranges, port_config
from benchmark.requests import Request
from benchmark.roofline import attention_work, request_work, score_work
from benchmark.trace import from_profiler
from benchmark.weights import lm_layer_specs, make_weights

MAN = Manifest()


def _config(name):
    return MAN.config({"config": name})


def digest(sd):
    """SHA-256 of every tensor's name and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(sd):
        h.update(name.encode())
        h.update(sd[name].contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# recorded from the function before weights were drawn by layer group
@pytest.mark.parametrize("preset_name, dtype, want", [
    ("tiny", torch.bfloat16, "9c56a17b03d0b1d1e481a9ddba08984fffbe2e65c78058f0afcbc51777314913"),
    ("tiny", torch.float32, "5cb4bf87a0ea9f905db5d15cdf56004ca2bea6b9ebb3865a3560d8ccce1afd38"),
    ("videoitg-8b-shallow", torch.bfloat16,
     "e5fa2699072bea4d87e199a47adb33ce914d3070f89cb31bbfbdddc9360a60af"),
    ("videoitg-8b-shallow", torch.float32,
     "d51e959f1eb6e48ea2496253444703d49e4415e37719d6af9324a10ecc013d5b"),
])
def test_the_existing_weights_are_unmoved(preset_name, dtype, want):
    from videoitg_tpu_torch.config import preset

    model = dataclasses.asdict(preset(preset_name))  # the shallow one: vocabulary 8192
    assert digest(make_weights(model, 2 ** 33 + 17, "cpu", dtype)) == want


# (bf16_ops, int8_ops, attention_s, attention_ops) of request_work and of
# score_work, recorded before the count took an architecture module
WORK = [
    ("videoitg-8b", 512, 256, True,
     (466825704898560.0, 0.0, 0.10214676757070171, 101023153127424.0),
     (170822865518592.0, 0.0, 0.06918469248077654, 68423660863488.0)),
    ("videoitg-8b", 512, 41, True,
     (464019830865920.0, 0.0, 0.09988692779331043, 98788171587584.0),
     (168016991485952.0, 0.0, 0.06692485270338525, 66188679323648.0)),
    ("videoitg-8b", 64, 161, False,
     (216477993467904.0, 0.0, 0.11110235766552072, 109880231731200.0),
     (216477993467904.0, 0.0, 0.11110235766552072, 109880231731200.0)),
    ("videoitg-8b-act8", 512, 256, True,
     (940192038912.0, 465885512859648.0, 0.10214676757070171, 101023153127424.0),
     (434533564416.0, 170388331954176.0, 0.06918469248077654, 68423660863488.0)),
    ("videoitg-8b-act8", 512, 100, False,
     (434533564416.0, 168352441958400.0, 0.06754125913043478, 66798305280000.0),
     (434533564416.0, 168352441958400.0, 0.06754125913043478, 66798305280000.0)),
]


@pytest.mark.parametrize("config, frames, text, tower, whole, score", WORK)
def test_the_existing_work_counts_are_unmoved(config, frames, text, tower, whole, score):
    cfg = _config(config)
    model, tier, arch = cfg["model"], cfg.get("tier"), reference_module(cfg)
    fields = lambda w: (w.bf16_ops, w.int8_ops, w.attention_s, w.attention_ops)  # noqa: E731
    assert fields(request_work(model, tier, frames, text, tower)) == whole
    assert fields(request_work(model, tier, frames, text, tower, arch)) == whole
    assert fields(score_work(model, tier, frames, text)) == score


@pytest.mark.parametrize("args, kwargs, want", [
    ((128, 16, 16, 729, 72), {}, (313456656384.0, 859963392.0)),  # kernel A
    ((1, 28, 4, 13056, 128), {"pairs": [12840 ** 2]}, (2363513241600.0, 213909504.0)),  # B
])
def test_the_existing_attention_counts_are_unmoved(args, kwargs, want):
    assert attention_work(*args, **kwargs) == want


@pytest.mark.parametrize("config", ["videoitg-8b", "videoitg-8b-act8"])
def test_port_config_is_the_ports_own_reading(config):
    from videoitg_tpu_torch.config import GroundingConfig, LMConfig, ProjectorConfig, VisionConfig

    model = _config(config)["model"]
    parts = {"vision": VisionConfig, "projector": ProjectorConfig, "lm": LMConfig}
    want = GroundingConfig(**{k: parts[k](**v) if k in parts else v for k, v in model.items()})
    got = port_config(model)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in parts:
            for g in dataclasses.fields(b):
                assert getattr(a, g.name) == getattr(b, g.name), (f.name, g.name)
        else:
            assert a == b, f.name
    assert got == want


def _tiny_engine():
    from videoitg_tpu_torch.config import preset

    cfg = {"model": dataclasses.asdict(preset("tiny")), "dtype": "float32", "tier": None,
           "kernels": {"qgemm": False, "fused": False, "lm_splash": False}}
    state = make_weights(cfg["model"], 11, "cpu", torch.float32)
    return cfg, build_engine(cfg, state, torch.device("cpu"))


def test_install_ranges_by_default_opens_qwen2_and_siglip_mha():
    from torch.profiler import ProfilerActivity, profile, record_function

    from videoitg_tpu_torch.models import qwen2

    cfg, engine = _tiny_engine()
    mix = dict(MAN.mix(MAN.workload("itg8b.select512")), **TINY_MIX)
    video = make_traffic(mix, 3, "cpu").videos[0]
    orig = qwen2.mha
    calls = Calls()
    restore = install_ranges(calls)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench:window"):
                engine.select(video, list(range(len(video))), "what is on the table")
    finally:
        restore()
    assert qwen2.mha is orig
    cats = {r.cat for r in from_profiler(prof)[0]}
    assert {"qwen2.mha", "siglip.mha"} <= cats
    lm = cfg["model"]["lm"]
    (qs, ks, vs, valid), = calls.attention["qwen2.mha"][:1]
    assert qs[1] == lm["num_heads"] and ks[1] == vs[1] == lm["num_kv_heads"]
    assert vs[-1] == lm["head_dim"] and len(calls.attention["qwen2.mha"]) == lm["num_layers"]
    n = int(valid.sum())
    assert calls.attention_work("qwen2.mha")[0] == attention_work(
        1, lm["num_heads"], lm["num_kv_heads"], qs[2], lm["head_dim"], pairs=[n * n])


def test_calls_count_v_at_its_own_head_dim():
    calls = Calls({"mla": [((1, 16, 64, 192), (1, 16, 64, 192), (1, 16, 64, 128), None)]})
    assert calls.attention_work("mla") == [attention_work(1, 16, 16, 64, 192, dv=128)]


# ---- a second architecture by new files alone ----

STANDIN = '''"""A stand-in architecture: model.py's forward, so that the port still
runs it, with the LM's layers drawn in two groups, its calls of `scores`
counted, a marked work count and another name of the port's qwen2 module
as the LM's attention entry."""

import numpy as np

from benchmark.reference import model as _model
from benchmark.roofline import Work
from benchmark.weights import lm_layer_specs

encode = _model.encode
CALLS = []   # instructions scored
GROUPS = []  # draws of the LM's groups
SHIFT = [0.0]  # added to every logit it answers
MARK = 1234.5  # seconds of least time a question
LM_ATTENTION = ("qwen2", "apply_rope")


def scores(sd, cfg, img, n_frames, instruction):
    CALLS.append(instruction)
    p = _model.scores(sd, cfg, img, n_frames, instruction)
    return 1.0 / (1.0 + np.exp(-(np.log(p) - np.log1p(-p) + SHIFT[0])))


def lm_layer_groups(lm):
    GROUPS.append(lm["num_layers"])
    specs = lm_layer_specs(lm)
    return [(range(1), specs), (range(1, lm["num_layers"]), specs)]


def score_work(model, tier, frames, text_tokens):
    return Work(attention_s=MARK)
'''


def _files(root):
    out = {}
    for d, dirs, names in os.walk(os.path.join(root, "benchmark")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for n in names:
            if not n.endswith(".pyc"):
                path = os.path.join(d, n)
                out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """A copy of the benchmark with a configuration that names the stand-in,
    and one traced run of its cell on the CPU."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    from videoitg_tpu_torch.config import preset

    with open(os.path.join(root, "benchmark", "reference", "standin.py"), "w") as f:
        f.write(STANDIN)
    cfg = dict(_config("videoitg-8b"), name="standin-tiny", reference="standin",
               model=dataclasses.asdict(preset("tiny")))
    with open(os.path.join(root, "benchmark", "configs", "standin-tiny.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    spec = json.loads(json.dumps(MAN.spec))
    spec["configs"].append({"name": "standin-tiny", "source": "https://huggingface.co/org/x",
                            "file": "benchmark/configs/standin-tiny.json", "reduced": [],
                            "why": "another LM architecture, as new files"})
    spec["workloads"].append({"name": "standin.reuse12", "config": "standin-tiny",
                              "traffic": "reuse12", "chips": 1, "why": "the stand-in"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)

    man = Manifest(root=root)
    wl = man.workload("standin.reuse12")
    cfg = man.config(wl)
    mix = dict(man.mix(wl), **TINY_MIX)
    arch = man.reference(cfg)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        result = run_cell(cfg, mix, man.client(mix), {}, 20261019, 0.3, True,
                          torch.device("cpu"), time.perf_counter(), arch)
    return SimpleNamespace(root=root, man=man, wl=wl, cfg=cfg, mix=mix, arch=arch,
                           result=result, log=err.getvalue())


def test_the_standin_needs_new_files_alone(standin):
    ours, theirs = _files(ROOT), _files(standin.root)
    assert set(theirs) - set(ours) == {"benchmark/reference/standin.py",
                                       "benchmark/configs/standin-tiny.json"}
    assert all(theirs[k] == v for k, v in ours.items())
    spec = standin.man.spec
    for group in MAN.spec:
        old = MAN.spec[group]
        assert (spec[group][: len(old)] if isinstance(old, list) else spec[group]) == old
    assert standin.arch.__file__ == os.path.join(standin.root, "benchmark", "reference",
                                                 "standin.py")


def test_correct_is_decided_by_the_standins_scores(standin):
    n = int(re.search(r"check: (\d+) requests", standin.log).group(1))
    assert standin.result["correct"] is True, standin.result["checks"]
    assert n >= 1 and len(standin.arch.CALLS) == n
    standin.arch.SHIFT[0] = 1.0
    try:
        result = run_cell(standin.cfg, standin.mix, standin.man.client(standin.mix), {},
                          20261020, 0.2, False, torch.device("cpu"), time.perf_counter(),
                          standin.arch)
    finally:
        standin.arch.SHIFT[0] = 0.0
    assert result["correct"] is False
    assert result["checks"]["logit_max"]["value"] == pytest.approx(1.0, abs=0.05)


def test_the_weights_follow_the_standins_groups(standin):
    # the run drew the program's weights and the reference's by its groups
    assert len(standin.arch.GROUPS) >= 2
    model = standin.cfg["model"]
    ours = make_weights(model, 7, "cpu", torch.float32, standin.arch)
    one = make_weights(model, 7, "cpu", torch.float32)
    assert ours.keys() == one.keys()
    storage = lambda t: t.untyped_storage().data_ptr()  # noqa: E731
    for name, *_ in lm_layer_specs(model["lm"]):
        a, b = f"lm.layers.0.{name}", f"lm.layers.1.{name}"
        assert storage(ours[a]) != storage(ours[b]) and storage(one[a]) == storage(one[b])
    assert all(torch.equal(ours[k], one[k]) for k in ours if not k.startswith("lm.layers."))
    assert not all(torch.equal(ours[k], one[k]) for k in ours if k.startswith("lm.layers."))


def test_mfu_pct_reads_the_standins_work(standin):
    entry = [m for m in standin.man.spec["per_layer"] if m["name"] == "mfu_pct"]
    reader, _ = standin.man.readers(entry)["mfu_pct"]
    trace = SimpleNamespace(busy_s=1.0, window_s=2.0)
    reqs = [Request(video=0, group=0, instruction="what", frames=8, questions=3, encoded=False)]

    def mfu(cfg, arch):
        return reader.read(Run(cfg, standin.mix, reqs, 2.0, 0.0, 0, trace, None, arch))

    assert mfu(standin.cfg, standin.arch) == 100.0 * standin.arch.MARK * 3 / 2.0
    assert mfu(standin.cfg, None) < 1.0
    cfg = _config("videoitg-8b")
    assert mfu(cfg, reference_module(cfg)) == mfu(cfg, None)


def test_ranges_open_at_the_standins_lm_attention(standin):
    counts = ast.literal_eval(re.search(r"ranges (\{.*\})", standin.log).group(1))
    assert counts.get("qwen2.apply_rope", 0) > 0 and counts.get("siglip.mha", 0) > 0
    assert "qwen2.mha" not in counts
