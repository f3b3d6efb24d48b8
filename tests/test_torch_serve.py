"""The port's serving daemon (`videoitg_tpu_torch/cli/serve.py`): the cases of
tests/test_serve.py and of tests/test_encode_reuse.py's LRU test on the port,
the port's daemon against the JAX daemon on bridged weights, decode-ahead
with `preprocess_ahead` on worker threads, the CLI's refusal in a child
process, and the CLI on a device mesh of gloo ranks launched as torchrun
launches them. CPU, fp32, `preset("tiny")`; every case decodes a video and skips
where the libav reader cannot be built.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.cli import serve as jax_serve
from videoitg_tpu.config import preset as jax_preset
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.utils.common import CharTokenizer
from videoitg_tpu_torch.cli import serve
from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.data import prefetch, video
from videoitg_tpu_torch.engine import SelectionEngine

from _torch_bridge import bridged_pair, tiny_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = preset("tiny")
KEYS = {"index", "logits", "num_frames", "contexts", "video_path", "doc_id", "selected"}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    try:
        return [video.write_test_video(str(root / f"v{i}.mp4"), 64 + 8 * i, 48, 20 + 4 * i, 10, 8)
                for i in range(3)]
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")


@pytest.fixture(scope="module")
def weights():
    return bridged_pair(tiny_params(seed=0))


def _engine(weights, **kw):
    kw = dict(dict(num_frames=8, target_fps=4.0), **kw)
    return SelectionEngine(weights[1], CFG, CharTokenizer(CFG.lm.vocab_size), device="cpu",
                           dtype=torch.float32, use_flash=False, **kw)


def _listen(server):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(weights, videos):
    server = serve.SelectionServer(_engine(weights))
    httpd, base = _listen(server)
    yield base, videos, server
    httpd.shutdown()
    httpd.server_close()
    server.close()
    assert not server._worker.is_alive() and server.engine is None and not server._cache


def _post(base, payload):
    req = urllib.request.Request(f"{base}/select", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_select_roundtrip_contract(served):
    base, videos, _ = served
    payload = {"video_path": videos[0], "prompt": "find it", "topk": 3, "doc_id": "d0"}
    status, out = _post(base, payload)
    assert status == 200
    assert set(out) == KEYS
    assert out["doc_id"] == "d0" and out["num_frames"] == 1 and out["contexts"] == "find it"
    assert len(out["selected"]) == 3 and out["selected"] == sorted(out["index"][:3])
    assert len(out["index"]) == len(set(out["index"])) == 8
    assert all(0.0 <= v <= 1.0 for v in out["logits"])
    assert out["logits"] == sorted(out["logits"], reverse=True)
    _, again = _post(base, payload)  # deterministic, and now from the LRU
    assert again["index"] == out["index"] and again["logits"] == out["logits"]
    _, default_k = _post(base, {"video_path": videos[0], "prompt": "find it"})
    assert default_k["selected"] == sorted(default_k["index"][:32])


def test_concurrent_burst_health_and_stats(served):
    base, videos, _ = served
    before = _get(base, "/healthz")
    results = [None] * 4

    def go(i):
        results[i] = _post(base, {"video_path": videos[i % 2], "prompt": f"q{i}", "topk": 2})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 and len(r[1]["selected"]) == 2 for r in results)
    health = _get(base, "/healthz")
    assert health["ok"] and health["pending"] == 0
    assert health["served"] == before["served"] + 4
    assert set(health) == {"ok", "pending", "served", "encode_cache_hits"}
    stats = _get(base, "/stats")
    assert {"decode", "preprocess", "tower", "score"} >= set(stats) >= {"tower", "score"}
    assert stats["score"]["count"] == health["served"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nothing")
    assert e.value.code == 404


def test_bad_requests_are_isolated(served):
    base, videos, server = served
    assert _post(base, {"prompt": "missing video"})[0] == 400
    served_before = server.served
    status, out = _post(base, {"video_path": "/nonexistent.mp4", "prompt": "x"})
    assert status == 500 and set(out) == {"error"} and "nonexistent" in out["error"]
    assert server.served == served_before
    status, out = _post(base, {"video_path": videos[1], "prompt": "ok"})  # the worker survives
    assert status == 200 and "selected" in out
    req = urllib.request.Request(f"{base}/elsewhere", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 404


def test_encode_cache_hits_eviction_and_off(weights, videos):
    """tests/test_encode_reuse.py::test_serve_encode_cache on the port, plus
    LRU order: a slot is reused while it is among the newest `encode_cache`."""
    engine = _engine(weights, buckets=(4, 8))
    server = serve.SelectionServer(engine, decode_workers=1, encode_cache=2)
    a, b, c = videos
    r1 = server.submit({"video_path": a, "prompt": "one?", "topk": 4})
    r2 = server.submit({"video_path": a, "prompt": "two?", "topk": 4})
    assert "error" not in r1 and "error" not in r2
    assert (server.cache_hits, server.served) == (1, 2)
    assert set(r1) == KEYS and sorted(r1["selected"]) == r1["selected"]
    assert set(r1["index"]) == set(r2["index"])
    towers = engine.timer.summary()["tower"]["count"]
    assert towers == 1  # the hit ran no tower
    # A hit scores exactly what a fresh engine scores for that prompt.
    fresh = _engine(weights, buckets=(4, 8)).select_from_file(a, "two?")
    assert r2["index"] == fresh.index and r2["logits"] == fresh.logits
    server.submit({"video_path": b, "prompt": "b"})      # cache: a, b
    server.submit({"video_path": a, "prompt": "again"})  # hit; a becomes newest: b, a
    server.submit({"video_path": c, "prompt": "c"})      # evicts b: a, c
    assert server.cache_hits == 2 and len(server._cache) == 2
    server.submit({"video_path": a, "prompt": "still here"})
    assert server.cache_hits == 3
    server.submit({"video_path": b, "prompt": "gone"})
    assert server.cache_hits == 3 and engine.timer.summary()["tower"]["count"] == 4
    off = serve.SelectionServer(engine, decode_workers=1, encode_cache=0)
    off.submit({"video_path": a, "prompt": "one?"})
    off.submit({"video_path": a, "prompt": "two?"})
    assert off.cache_hits == 0 and off.served == 2 and not off._cache


def test_encode_key_tells_files_and_settings_apart(weights, videos, tmp_path):
    server = serve.SelectionServer(_engine(weights))
    other = serve.SelectionServer(_engine(weights, num_frames=4))
    key = server._encode_key(videos[0], "eval")
    assert key == server._encode_key(videos[0], "eval")
    assert key != server._encode_key(videos[0], "infer")
    assert key != server._encode_key(videos[1], "eval")
    assert key != other._encode_key(videos[0], "eval")
    missing = server._encode_key(str(tmp_path / "none.mp4"), "eval")
    assert missing[1:3] == (-1, -1)


def test_burst_is_grouped_by_sampling(weights, videos, monkeypatch):
    """One drained burst with both sampling modes: one decode_ahead call per
    mode, each with only its own requests, every request answered."""
    calls = []
    real = prefetch.decode_ahead

    def spy(items, **kw):
        items = list(items)
        calls.append((kw["sampling"], [path for _, path, _ in items], kw["pix_fmt"],
                      kw["post"].__name__))
        return real(items, **kw)

    monkeypatch.setattr(prefetch, "decode_ahead", spy)
    gate = threading.Event()
    drain = serve.SelectionServer._drain

    def gated(self):  # hold the worker until the whole burst is queued
        gate.wait(60)
        return drain(self)

    monkeypatch.setattr(serve.SelectionServer, "_drain", gated)
    server = serve.SelectionServer(_engine(weights), encode_cache=0)
    reqs = [{"video_path": videos[0], "prompt": "a", "sampling": "infer"},
            {"video_path": videos[1], "prompt": "b"},
            {"video_path": videos[0], "prompt": "c", "sampling": "eval"},
            {"video_path": videos[2], "prompt": "d", "sampling": "infer"}]
    out = [None] * len(reqs)
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, server.submit(reqs[i])))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    while server.requests.qsize() < len(reqs):
        threading.Event().wait(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None and "error" not in o for o in out), out
    assert len(calls) == 2 and all(c[2:] == ("rgb", "preprocess_ahead") for c in calls)
    by_mode = {mode: sorted(paths) for mode, paths, _, _ in calls}
    assert by_mode == {"infer": sorted([videos[0], videos[2]]),
                       "eval": sorted([videos[1], videos[0]])}
    infer = _engine(weights).select_from_file(videos[0], "a", sampling="infer")
    assert out[0]["index"] == infer.index


def test_yuv420_daemon_equals_rgb_daemon(weights, videos):
    results = {}
    for mode in ("rgb", "yuv420"):
        server = serve.SelectionServer(_engine(weights, transfer=mode))
        httpd, base = _listen(server)
        status, out = _post(base, {"video_path": videos[0], "prompt": "find it"})
        httpd.shutdown()
        httpd.server_close()
        assert status == 200
        results[mode] = out
    assert results["yuv420"]["index"] == results["rgb"]["index"]
    assert set(results["yuv420"]) == set(results["rgb"]) == KEYS
    np.testing.assert_allclose(results["yuv420"]["logits"], results["rgb"]["logits"], atol=0.03)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_port_daemon_matches_jax_daemon(weights, videos, transfer):
    """The same video, prompts and weights through both daemons: `index`
    identical, `logits` (2-dp scores) within atol 2e-5 of each other or one
    rounding step apart where a score sits on a boundary, cache hit included."""
    tok = CharTokenizer(CFG.lm.vocab_size)
    jax_engine = JaxEngine(weights[0], jax_preset("tiny"), tok, dtype=jnp.float32,
                           use_flash=False, num_frames=8, target_fps=4.0, transfer=transfer)
    theirs = jax_serve.SelectionServer(jax_engine)
    ours = serve.SelectionServer(_engine(weights, transfer=transfer))
    for prompt in ("find it", "and the second question?"):
        req = {"video_path": videos[1], "prompt": prompt, "topk": 5, "doc_id": 7}
        want, got = theirs.submit(dict(req)), ours.submit(dict(req))
        assert "error" not in want and "error" not in got, (want, got)
        assert got["index"] == want["index"] and got["selected"] == want["selected"]
        np.testing.assert_allclose(got["logits"], want["logits"], atol=0.01 + 1e-9)
        assert {k: got[k] for k in KEYS - {"index", "logits", "selected"}} == \
            {k: want[k] for k in KEYS - {"index", "logits", "selected"}}
    assert ours.cache_hits == theirs.cache_hits == 1
    # the unrounded scores behind the last response
    enc_key = ours._encode_key(videos[1], "eval")
    enc, sampled = ours._cache[enc_key]
    jenc, jsampled = theirs._cache[theirs._encode_key(videos[1], "eval")]
    assert sampled == jsampled
    np.testing.assert_allclose(ours.engine.score_encoded(enc, ["find it"])[0],
                               jax_engine.score_encoded(jenc, ["find it"])[0], atol=2e-5, rtol=0)


def test_decode_ahead_posts_on_worker_threads(weights, videos):
    """`decode_ahead(..., post=engine.preprocess_ahead)`: order kept, errors
    surfaced per item, the post step off the calling thread, results usable by
    `encode_video`."""
    engine = _engine(weights)
    seen = []

    def post(frames):
        seen.append(threading.current_thread() is threading.main_thread())
        return engine.preprocess_ahead(frames)

    items = [("k0", videos[0], 0), ("bad", "/nonexistent.mp4", 1), ("k2", videos[2], 2)]
    out = list(prefetch.decode_ahead(items, num_frames=8, target_fps=4.0, workers=2, ahead=2,
                                     post=post))
    assert [d.key for d in out] == ["k0", "bad", "k2"] and [d.meta for d in out] == [0, 1, 2]
    assert out[1].error is not None and out[1].frames is None
    assert seen == [False, False]
    for d, path in ((out[0], videos[0]), (out[2], videos[2])):
        enc = engine.encode_video(d.frames)
        want = engine.select_from_file(path, "q")
        assert d.sampled == want.sampled_frames
        np.testing.assert_allclose(engine.score_encoded(enc, ["q"])[0], want.raw_scores,
                                   atol=2e-5, rtol=0)


def test_close_answers_what_is_queued_then_stops(weights, videos):
    server = serve.SelectionServer(_engine(weights))
    out = [None, None]
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, server.submit({"video_path": videos[i], "prompt": "q"}))) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    server.close()
    assert all(o is not None and "error" not in o for o in out)
    assert not server._worker.is_alive() and server.engine is None and not server._cache


def test_parser_has_every_flag_of_the_jax_daemon():
    def flags(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions if a.dest != "help"}

    want, got = flags(jax_serve.build_parser()), flags(serve.build_parser())
    assert got == want


def test_warmup_runs_each_bucket(weights, videos):
    engine = _engine(weights, buckets=(4, 8, 16), num_frames=16, target_fps=10.0)
    serve.warmup(engine, [8, 16])
    summary = engine.timer.summary()
    assert summary["decode"]["count"] == 2 and summary["score"]["count"] == 2


def _cli(*flags, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "videoitg_tpu_torch.cli.serve", *flags],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


REFUSED = [
    # a serving directory of the JAX package's layout (an orbax params/ tree);
    # the id is the one this case had when every serving directory was refused
    pytest.param(("--model", "{serving}"), "--export-serving", "orbax params/ tree",
                 id="flags0---model-ROADMAP queue 1, item 4"),
]


@pytest.mark.parametrize("flags,named,item", REFUSED)
def test_cli_refuses_what_is_not_ported(tmp_path, flags, named, item):
    """A serving directory of the JAX package's layout as `--model` is
    refused, naming the re-export (`videoitg-torch-select --export-serving`).
    HF-format and the port's serving `--model` directories are served."""
    (tmp_path / "serving" / "params").mkdir(parents=True)
    (tmp_path / "serving" / "serving_config.json").write_text(
        '{"format": "videoitg-serving-v1", "quantize": null, "config": {}}')
    flags = [f.format(serving=tmp_path / "serving") for f in flags]
    proc = _cli("--preset", "tiny", "--random-init", "--cpu", "--port", "0", *flags, cwd=tmp_path)
    assert proc.returncode == 2
    assert named in proc.stderr and item in proc.stderr
    assert ("not ported" in proc.stderr) == item.startswith("ROADMAP")


# --flag N on a world of that many gloo ranks, launched as torchrun launches
# them (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR / MASTER_PORT): the mesh
# /healthz must report and the transfer (the pp world ships YUV planes)
MESHES = {"--tp": (2, {"dp": 1, "tp": 2}, "rgb"), "--dp": (4, {"dp": 4, "tp": 1}, "rgb"),
          "--sp": (2, {"dp": 1, "tp": 1, "sp": 2}, "rgb"),
          "--pp": (2, {"pp": 2, "dp": 1, "tp": 1}, "yuv420")}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def mesh_daemons(tmp_path_factory):
    """One daemon world per MESHES entry, all started together; yields
    {flag: (rank 0's base URL, the ranks' processes)}."""
    tmp = tmp_path_factory.mktemp("mesh_daemons")
    worlds = {}
    for flag, (world, _, transfer) in MESHES.items():
        master = str(_free_port())
        worlds[flag] = [subprocess.Popen(
            [sys.executable, "-m", "videoitg_tpu_torch.cli.serve", "--preset", "tiny",
             "--random-init", "--cpu", "--port", "0", "--num-frames", "8", "--target-fps", "4",
             "--transfer", transfer, flag, str(world)],
            cwd=tmp, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(world), RANK=str(r),
                     LOCAL_RANK=str(r), MASTER_ADDR="localhost", MASTER_PORT=master,
                     OMP_NUM_THREADS="1"))
            for r in range(world)]
    bases = {}
    try:
        for flag, procs in worlds.items():
            for line in procs[0].stderr:
                if "listening on" in line:
                    bases[flag] = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
                    break
        yield {flag: (bases.get(flag), procs) for flag, procs in worlds.items()}
    finally:
        for procs in worlds.values():
            procs[0].terminate()  # the leader stops its followers
        for procs in worlds.values():
            for p in procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()


@pytest.mark.parametrize("flag", sorted(MESHES))
def test_cli_serves_on_a_mesh_of_gloo_ranks(mesh_daemons, videos, flag):
    """`--tp 2`, `--dp 4`, `--sp 2`, `--pp 2` (YUV planes) under a
    torchrun-style launch: rank 0 answers POST /select with the one-rank
    daemon's answer (the same random-init weights), a video that does not
    decode is an error for that request only, /healthz reports the mesh, and
    a stopped leader stops every rank with exit code 0."""
    from videoitg_tpu_torch.cli._model_loading import load_grounding_components

    base, procs = mesh_daemons[flag]
    assert base is not None, procs[0].stderr.read()[-3000:]
    params, cfg, tok = load_grounding_components(None, "tiny", True, torch.float32,
                                                 torch.device("cpu"), seed=0)
    one = serve.SelectionServer(SelectionEngine(params, cfg, tok, device="cpu",
                                                dtype=torch.float32, num_frames=8,
                                                target_fps=4.0, transfer=MESHES[flag][2]))
    try:
        status, bad = _post(base, {"video_path": "/no/such/video.mp4", "prompt": "q"})
        assert status == 500 and "error" in bad
        for v in videos[:2]:
            req = {"video_path": v, "prompt": "where is it?", "topk": 3}
            status, got = _post(base, req)
            want = one.submit(req)
            assert status == 200 and set(got) == KEYS
            assert got["selected"] == want["selected"] and got["index"] == want["index"]
            np.testing.assert_allclose(got["logits"], want["logits"], atol=0.01 + 1e-9)
        status, again = _post(base, {"video_path": videos[0], "prompt": "where is it?"})
        assert status == 200  # an LRU hit on every rank
        health = _get(base, "/healthz")
        assert health["mesh"] == MESHES[flag][1] and health["encode_cache_hits"] == 1
    finally:
        one.close()
    procs[0].terminate()
    rcs = [p.wait(timeout=60) for p in procs]
    assert rcs == [0] * len(procs), [p.stderr.read()[-2000:] for p in procs]


def test_cli_stops_without_a_cuda_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _cli("--preset", "tiny", "--random-init", "--port", "0", cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device found" in proc.stderr and "--cpu" in proc.stderr
    assert "listening" not in proc.stderr
    proc = _cli("--preset", "tiny", "--cpu", "--port", "0", cwd=tmp_path)  # no --random-init
    assert proc.returncode == 2 and "--random-init" in proc.stderr


def test_cli_serves_over_http_on_the_cpu(videos, tmp_path):
    """`python -m videoitg_tpu_torch.cli.serve --cpu --port 0 --warmup`: the
    process announces its port, answers /select and /healthz, and loads
    neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = ("import sys\n"
            "from http.server import ThreadingHTTPServer\n"
            "from videoitg_tpu_torch.cli import serve\n"
            "forever = ThreadingHTTPServer.serve_forever\n"
            "def report_then_serve(self):\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'videoitg_tpu'))\n"
            "    print('FOREIGN', bad, file=sys.stderr, flush=True)\n"
            "    forever(self)\n"
            "ThreadingHTTPServer.serve_forever = report_then_serve\n"
            "sys.exit(serve.main(sys.argv[1:]))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--preset", "tiny", "--random-init", "--cpu", "--port", "0",
         "--num-frames", "8", "--target-fps", "4", "--warmup", "--transfer", "yuv420"],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port, foreign = None, None
        for line in proc.stderr:
            if line.startswith("FOREIGN"):
                foreign = line.split(" ", 1)[1].strip()
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
            if port is not None and foreign is not None:
                break
        assert port and foreign == "[]", (port, foreign)
        base = f"http://127.0.0.1:{port}"
        status, out = _post(base, {"video_path": videos[0], "prompt": "find it", "topk": 2})
        assert status == 200 and set(out) == KEYS and len(out["selected"]) == 2
        health = _get(base, "/healthz")
        assert health["ok"] and health["served"] == 1
        assert _get(base, "/stats")["decode"]["count"] == 1  # the warm-up's own decode
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stderr.close()
