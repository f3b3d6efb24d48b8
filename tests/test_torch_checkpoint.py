"""HF-format checkpoints in the port (videoitg_tpu_torch/checkpoint.py).

The port's own safetensors codec against the `safetensors` package, both
ways; HF directories of the JAX package's layout loaded into the port equal,
leaf for leaf, to the numpy bridge (`params_from_numpy`) of the same tree,
for every projector family and for a causal VLM with an `lm_head`; the port's
directories loaded by the JAX package's converter at 1e-6; the Top-K index
of both engines from one directory; the three CLIs with `--model DIR --cpu`
in child processes, on a tokenizer built offline. fp32 on the CPU.

The JAX package's state dicts are written here with `safetensors.numpy`
after `np.ascontiguousarray`: the installed safetensors writes a transposed
(non-contiguous) numpy array's bytes in memory order under the transposed
shape, so the JAX `save_hf_checkpoint` scrambles every Linear weight of the
file it writes (`test_jax_save_hf_checkpoint_file_is_read_as_written` pins
what is on disk, which both readers read alike).
"""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as pt_save_file

from _torch_bridge import family_cfgs
from videoitg_tpu import checkpoint as jax_ckpt
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu_torch import checkpoint as ckpt
from videoitg_tpu_torch.config import GroundingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 1e-4
FAMILIES = ["seq_mlp", "linear", "mlp3x_gelu", "identity"]
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _random(dtype, shape, gen):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), shape, generator=gen,
                         dtype=torch.int64).to(dtype)


def write_hf_dir(sd, cfg_json: str, path, filename="model.safetensors"):
    """A reference-layout directory from a numpy state dict, written by the
    safetensors package."""
    os.makedirs(path, exist_ok=True)
    np_save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                 os.path.join(path, filename))
    with open(os.path.join(path, ckpt.CONFIG_NAME), "w") as f:
        f.write(cfg_json)
    return str(path)


def write_tokenizer(path):
    """A word-level fast tokenizer that AutoTokenizer loads, built offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ("find the frames where rocket launches what happens when color changes a is "
             "of to in and dog turn it").split()
    vocab = {"<unk>": 0, **{w: i + 1 for i, w in enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>"}, f)


def jax_pair(ptype="seq_mlp", seed=0):
    jcfg, cfg = family_cfgs(ptype)
    params = jax_init_grounding(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jcfg, cfg, params


def assert_same_model(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


# ---- the codec ----


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_file_reads_in_the_safetensors_package(tmp_path, name):
    dtype, gen = DTYPES[name], torch.Generator().manual_seed(1)
    tensors = {"a.weight": _random(dtype, (3, 5), gen), "b": _random(dtype, (7,), gen),
               "scalar": _random(dtype, (), gen), "empty": _random(dtype, (0, 4), gen)}
    path = str(tmp_path / "port.safetensors")
    n = ckpt.save_safetensors(tensors, path, metadata={"format": "pt", "note": "x"})
    assert n == os.path.getsize(path)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors) and f.metadata() == {"format": "pt",
                                                                          "note": "x"}
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and got.shape == t.shape and torch.equal(_bits(got), _bits(t))
    if dtype != torch.bfloat16:  # numpy has no bfloat16
        with safe_open(path, framework="np") as f:
            for k, t in tensors.items():
                np.testing.assert_array_equal(f.get_tensor(k), t.numpy())


@pytest.mark.parametrize("writer,name", [("np", n) for n in ("F32", "F16", "I8", "I32", "I64")]
                         + [("pt", n) for n in ("F32", "F16", "BF16", "I8")])
def test_safetensors_package_files_read_bit_for_bit(tmp_path, writer, name):
    dtype, gen = DTYPES[name], torch.Generator().manual_seed(2)
    tensors = {"x": _random(dtype, (4, 6), gen), "y.bias": _random(dtype, (9,), gen),
               "z": _random(dtype, (2, 3, 5), gen)}
    path = str(tmp_path / f"{writer}.safetensors")
    if writer == "np":
        np_save_file({k: t.numpy() for k, t in tensors.items()}, path)
    else:
        pt_save_file(tensors, path)
    got = ckpt.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == dtype and got[k].shape == t.shape
        assert torch.equal(_bits(got[k]), _bits(t)), k


def test_codec_refuses_a_broken_file(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    ckpt.save_safetensors({"x": torch.zeros(4)}, path)
    header = json.dumps({"x": {"dtype": "F32", "shape": [5], "data_offsets": [0, 16]}}).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="x spans 16 bytes"):
        ckpt.read_safetensors(path)


def test_jax_save_hf_checkpoint_file_is_read_as_written(tmp_path):
    """What the JAX writer puts on disk reads the same through the port's
    codec and the safetensors package, tensor for tensor, under the names and
    shapes of the JAX export."""
    jcfg, _, params = jax_pair()
    path = jax_ckpt.save_hf_checkpoint(params, jcfg, str(tmp_path))
    ours = ckpt.read_safetensors(path)
    with safe_open(path, framework="np") as f:
        assert sorted(f.keys()) == sorted(ours)
        for k in f.keys():
            np.testing.assert_array_equal(ours[k].numpy(), f.get_tensor(k))
    exported = jax_ckpt.export_grounding_state_dict(params, jcfg)
    assert sorted(exported) == sorted(ours)
    for k, v in exported.items():
        assert tuple(ours[k].shape) == v.shape, k


@pytest.mark.parametrize("layout", ["sharded", "bin", "bf16"])
def test_directory_layouts_load(tmp_path, layout):
    """A sharded pair of safetensors files with an index, a directory of
    `.bin` pickles, and a bf16 directory (the reference trainer's dtype)."""
    jcfg, cfg, params = jax_pair(seed=3)
    sd = {k: torch.from_numpy(np.array(v, order="C"))
          for k, v in jax_ckpt.export_grounding_state_dict(params, jcfg).items()}
    names = sorted(sd)
    halves = (names[: len(names) // 2], names[len(names) // 2:])
    if layout == "sharded":
        weight_map = {}
        for i, part in enumerate(halves):
            fname = f"model-0000{i + 1}-of-00002.safetensors"
            pt_save_file({k: sd[k] for k in part}, str(tmp_path / fname))
            weight_map.update({k: fname for k in part})
        (tmp_path / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}))
    elif layout == "bin":
        for i, part in enumerate(halves):
            torch.save({k: sd[k] for k in part}, str(tmp_path / f"pytorch_model-{i}.bin"))
    else:
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        pt_save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / ckpt.CONFIG_NAME).write_text(cfg.to_json())
    loaded = ckpt.load_hf_state_dict(str(tmp_path))
    assert sorted(loaded) == names
    model, got_cfg = ckpt.load_grounding_model(str(tmp_path), device="cpu", dtype=torch.float32)
    assert got_cfg == cfg
    want = ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    if layout == "bf16":  # the bf16 rounding of the same numbers (Module.to is in place)
        bf16_model, _ = ckpt.load_grounding_model(str(tmp_path), device="cpu")
        assert_same_model(bf16_model, want.to(torch.bfloat16))
        want = want.float()
    assert_same_model(model, want)


def test_no_weights_raise(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no safetensors/bin weights"):
        ckpt.load_hf_state_dict(str(tmp_path))


# ---- the key table, both ways ----


@pytest.mark.parametrize("ptype", FAMILIES)
def test_jax_written_directory_loads_equal_to_the_bridge(tmp_path, ptype):
    jcfg, cfg, params = jax_pair(ptype)
    path = write_hf_dir(jax_ckpt.export_grounding_state_dict(params, jcfg), jcfg.to_json(),
                        tmp_path)
    model, got_cfg = ckpt.load_grounding_model(path, device="cpu", dtype=torch.float32)
    assert got_cfg == cfg and got_cfg.projector.projector_type == ptype
    assert_same_model(model, ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg))


@pytest.mark.parametrize("ptype", FAMILIES)
def test_port_written_directory_loads_into_jax(tmp_path, ptype):
    jcfg, cfg, params = jax_pair(ptype, seed=1)
    model = ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    path = ckpt.save_hf_checkpoint(model, cfg, str(tmp_path))
    assert os.path.basename(path) == "model.safetensors"
    back, back_cfg = jax_ckpt.load_grounding_model(str(tmp_path), dtype=jnp.float32)
    assert back_cfg == jcfg
    want, got = jax.tree_util.tree_flatten_with_path(params)[0], jax.tree.leaves(back)
    assert len(want) == len(got)
    for (where, a), b in zip(want, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(where))
    exported = ckpt.export_grounding_state_dict(model, cfg)
    theirs = jax_ckpt.export_grounding_state_dict(params, jcfg)
    assert sorted(exported) == sorted(theirs)
    for k, v in theirs.items():
        assert exported[k].dtype == torch.float32
        np.testing.assert_array_equal(exported[k].numpy(), v, err_msg=k)


def test_vlm_tree_with_lm_head_loads_equal_to_the_bridge(tmp_path):
    """A causal VLM checkpoint (untied `lm_head`, no scoring head) through
    `convert_vlm_checkpoint`, against the JAX converter and the bridge; the
    port's export writes it back."""
    jcfg, cfg = (dataclasses.replace(c, lm=dataclasses.replace(c.lm, causal=True))
                 for c in family_cfgs())
    params = jax_init_grounding(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    sd = jax_ckpt.export_grounding_state_dict(params, jcfg)
    del sd["out_proj.weight"], sd["out_proj.bias"]
    rng = np.random.default_rng(5)
    sd["lm_head.weight"] = rng.standard_normal((cfg.lm.vocab_size, cfg.lm.hidden_size),
                                               dtype=np.float32)
    path = write_hf_dir(sd, jcfg.to_json(), tmp_path)
    tree = jax_ckpt.convert_vlm_checkpoint(jax_ckpt.load_hf_state_dict(path), jcfg)
    assert "lm_head" in tree["lm"] and "out_proj" not in tree
    model = ckpt.convert_vlm_checkpoint(ckpt.load_hf_state_dict(path), cfg, device="cpu")
    assert_same_model(model, ckpt.params_from_numpy(jax.tree.map(np.asarray, tree), cfg))
    exported = ckpt.export_grounding_state_dict(model, cfg)
    assert sorted(exported) == sorted(sd)
    np.testing.assert_array_equal(exported["lm_head.weight"].numpy(), sd["lm_head.weight"])
    # A tied config reads the embedding and passes a stray lm_head over, as
    # the JAX converter does; an untied one without a head is refused.
    tied = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, tie_word_embeddings=True))
    assert not hasattr(ckpt.convert_vlm_checkpoint(ckpt.load_hf_state_dict(path), tied,
                                                   device="cpu").lm, "lm_head")
    del sd["lm_head.weight"]
    with pytest.raises(KeyError, match=r"missing \['lm_head.weight'\]"):
        ckpt.convert_vlm_checkpoint({k: torch.from_numpy(np.array(v, order="C"))
                                     for k, v in sd.items()}, cfg, device="cpu")


@pytest.mark.parametrize("ptype", ["seq_mlp", "mlp3x_gelu"])
def test_projector_only_writes_the_projector_and_the_head(tmp_path, ptype):
    jcfg, cfg, params = jax_pair(ptype, seed=2)
    model = ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    path = ckpt.save_hf_checkpoint(model, cfg, str(tmp_path), projector_only=True)
    assert os.path.basename(path) == "mm_projector.safetensors"
    sd = ckpt.read_safetensors(path)
    assert sd and all(k.startswith(("model.mm_projector.", "out_proj")) for k in sd)
    full = ckpt.export_grounding_state_dict(model, cfg)
    assert sorted(sd) == sorted(k for k in full if k.startswith(("model.mm_projector.",
                                                                  "out_proj")))
    for k, v in sd.items():
        assert torch.equal(v, full[k]), k
    assert json.loads((tmp_path / ckpt.CONFIG_NAME).read_text()) == json.loads(cfg.to_json())


def test_export_refuses_quantised_and_lora_linears(tmp_path):
    from videoitg_tpu_torch.ops.quant import apply_quantization_tier
    from videoitg_tpu_torch.train.lora import add_lora, merge_lora

    _, cfg, params = jax_pair(seed=4)
    tree = jax.tree.map(np.asarray, params)
    model = apply_quantization_tier(ckpt.params_from_numpy(tree, cfg), "int8")
    with pytest.raises(ValueError, match="export requires unquantized weights"):
        ckpt.save_hf_checkpoint(model, cfg, str(tmp_path / "q"))
    assert not (tmp_path / "q").exists()
    model = ckpt.params_from_numpy(tree, cfg)
    add_lora(model, torch.Generator().manual_seed(0), rank=2)
    with pytest.raises(ValueError, match="merge_lora"):
        ckpt.export_grounding_state_dict(model, cfg)
    merge_lora(model)
    assert "model.layers.0.self_attn.q_proj.weight" in ckpt.export_grounding_state_dict(
        model, cfg)


def test_unknown_and_missing_keys_raise_and_name_the_keys():
    jcfg, cfg, params = jax_pair(seed=6)
    sd = {k: torch.from_numpy(np.array(v, order="C"))
          for k, v in jax_ckpt.export_grounding_state_dict(params, jcfg).items()}
    vp = "model.vision_tower.vision_tower.vision_model."
    # What no module reads passes: SigLIP's post-LN and head, old buffers,
    # an LM head the grounding model has no use for.
    unused = {vp + "post_layernorm.weight": torch.ones(32), vp + "head.probe": torch.ones(1, 32),
              vp + "embeddings.position_ids": torch.arange(16)[None],
              "model.layers.0.self_attn.rotary_emb.inv_freq": torch.ones(6),
              "lm_head.weight": torch.ones(cfg.lm.vocab_size, cfg.lm.hidden_size)}
    model = ckpt.convert_grounding_checkpoint({**sd, **unused}, cfg, device="cpu")
    assert_same_model(model, ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    broken = dict(sd, **{"model.layers.0.mlp.extra.weight": torch.ones(2)})
    del broken["model.norm.weight"]
    with pytest.raises(KeyError) as e:
        ckpt.convert_grounding_checkpoint(broken, cfg, device="cpu")
    assert "missing ['model.norm.weight']" in str(e.value)
    assert "unexpected ['model.layers.0.mlp.extra.weight']" in str(e.value)
    sd["model.norm.weight"] = torch.ones(7)
    with pytest.raises(ValueError, match="model.norm.weight"):
        ckpt.convert_grounding_checkpoint(sd, cfg, device="cpu")


def test_config_resolution(tmp_path):
    """An explicit cfg, else videoitg_tpu_config.json, else VideoITG-8B."""
    jcfg, cfg, params = jax_pair(seed=8)
    path = write_hf_dir(jax_ckpt.export_grounding_state_dict(params, jcfg), jcfg.to_json(),
                        tmp_path / "a")
    assert ckpt.read_config(path) == cfg
    os.remove(os.path.join(path, ckpt.CONFIG_NAME))
    assert ckpt.read_config(path) == GroundingConfig.videoitg_8b()
    model, got = ckpt.load_grounding_model(path, cfg=cfg, device="cpu", dtype=torch.float32)
    assert got is cfg and model.lm.embed.w.dtype == torch.float32


# ---- both engines from one directory ----


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny checkpoint written by the port, with a tokenizer."""
    jcfg, cfg, params = jax_pair(seed=11)
    path = tmp_path_factory.mktemp("hf_ckpt")
    ckpt.save_hf_checkpoint(ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg), cfg,
                            str(path))
    write_tokenizer(str(path))
    return path


def test_topk_index_identical_through_both_engines(model_dir):
    from transformers import AutoTokenizer

    from videoitg_tpu.engine import SelectionEngine as JaxEngine
    from videoitg_tpu_torch.engine import SelectionEngine

    tok = AutoTokenizer.from_pretrained(str(model_dir))
    params, jcfg = jax_ckpt.load_grounding_model(str(model_dir), dtype=jnp.float32)
    model, cfg = ckpt.load_grounding_model(str(model_dir), device="cpu", dtype=torch.float32)
    kw = dict(buckets=(8,), num_frames=8)
    jax_engine = JaxEngine(params, jcfg, tok, dtype=jnp.float32, use_flash=False, **kw)
    port = SelectionEngine(model, cfg, tok, device="cpu", dtype=torch.float32, **kw)
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (7, 56, 56, 3), dtype=np.uint8)
    sampled = [3 * i for i in range(7)]
    for prompt in ("find the frames where the rocket launches", "what color is the dog"):
        want = jax_engine.select(frames, sampled, prompt)
        got = port.select(frames, sampled, prompt)
        assert got.index == want.index
        np.testing.assert_allclose(got.raw_scores, want.raw_scores, atol=ATOL, rtol=0)


# ---- the CLIs on --model DIR ----


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    from videoitg_tpu_torch.data.video import write_test_video

    root = tmp_path_factory.mktemp("hf_cli")
    try:
        for name, n in (("a.mp4", 40), ("b.mp4", 50)):
            write_test_video(str(root / name), 64, 48, n, 10, 12)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    return root


def _run(module, *flags, cwd):
    return subprocess.run([sys.executable, "-m", f"videoitg_tpu_torch.cli.{module}", *flags],
                          cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=600)


def test_cli_select_model_dir(model_dir, videos):
    proc = _run("select", "--model", str(model_dir), "--cpu", "--video", str(videos / "a.mp4"),
                "--prompt", "find the rocket", "--topk", "2", "--num-frames", "4", "--json",
                cwd=videos)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(record["index"]) == 4 and "random weights" not in proc.stderr


def test_cli_serve_model_dir(model_dir, videos):
    proc = subprocess.Popen(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.serve", "--model", str(model_dir), "--cpu",
         "--port", "0", "--num-frames", "8", "--target-fps", "4"],
        cwd=videos, env=dict(os.environ, PYTHONPATH=REPO), stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "the daemon did not start"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/select", method="POST",
            data=json.dumps({"video_path": str(videos / "b.mp4"), "prompt": "find the dog",
                             "topk": 3}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read())
        assert len(out["selected"]) == 3 and len(out["index"]) == 8
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stderr.close()


@pytest.fixture(scope="module")
def train_data(videos):
    records = [{"video": "a.mp4", "question": "where is the dog?", "clip_num": [0, 2]},
               {"video": "b.mp4", "question": "when does it turn?", "clip_num": [1]}]
    (videos / "ground.json").write_text(json.dumps(records))
    convs = [{"from": "human", "value": "<image>\nwhat happens in the video?"},
             {"from": "gpt", "value": "the rocket launches and the color changes"}]
    (videos / "sft.json").write_text(json.dumps([{"video": "a.mp4", "conversations": convs},
                                                 {"video": "b.mp4", "conversations": convs}]))
    return videos


@pytest.fixture(scope="module")
def vlm_dir(tmp_path_factory):
    """A causal VLM checkpoint (untied lm_head) of `preset("tiny")`."""
    jcfg, cfg, params = jax_pair(seed=13)
    sd = jax_ckpt.export_grounding_state_dict(params, jcfg)
    sd["lm_head.weight"] = np.random.default_rng(13).standard_normal(
        (cfg.lm.vocab_size, cfg.lm.hidden_size), dtype=np.float32) * 0.05
    path = write_hf_dir(sd, jcfg.to_json(), tmp_path_factory.mktemp("vlm_ckpt"))
    write_tokenizer(path)
    return path


@pytest.mark.parametrize("objective", ["grounding", "vlm"])
def test_cli_train_model_dir_takes_three_steps(model_dir, vlm_dir, train_data, objective):
    data, model = (("ground.json", model_dir) if objective == "grounding"
                   else ("sft.json", vlm_dir))
    proc = _run("train", "--model", str(model), "--preset", "tiny", "--objective", objective,
                "--data-path", data, "--image-folder", ".", "--video-frames", "4", "--fps", "1",
                "--num-train-epochs", "4", "--total-steps", "3", "--output-dir", objective,
                "--cpu", cwd=train_data)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step ")]
    assert len(lines) == 3 and lines[-1].startswith("[train] step 3/3 loss="), proc.stdout
    rows = [json.loads(line) for line in open(train_data / objective / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
