"""Long-running frame-selection service on the PyTorch port.

Counterpart of videoitg_tpu/cli/serve.py (`videoitg-serve`). Production
selection wants a persistent process: the weights stay on the card, the
kernels are built once, and every request is served at steady-state latency.

* one SelectionEngine held hot,
* a request queue drained by a scoring worker that decodes ahead on host
  threads (data/prefetch.decode_ahead, with the upload and the resize on the
  worker thread too: engine.preprocess_ahead) while the card scores,
* an encoded-video LRU (--encode-cache): the tower never sees the prompt, so
  repeat prompts against a cached video skip decode + preprocess + tower and
  pay only the LM pass (the chat-with-a-video pattern),
* plain-stdlib HTTP (ThreadingHTTPServer), so air-gapped deployments carry no
  extra dependencies.

API:
  POST /select   {"video_path": ..., "prompt": ..., "topk": 32,
                  "doc_id": ..., "sampling": "eval"|"infer"}
              -> the results.jsonl record (index/logits/contexts/...) plus
                 "selected": the Top-K downstream contract (first k
                 score-descending, sorted ascending).
  GET /healthz -> {"ok": true, "pending": N, "served": M,
                   "encode_cache_hits": H} (+ "mesh": {axis: size} on a mesh)
  GET /stats   -> per-stage timing summary (decode/preprocess/tower/score).

It runs on the card; `--cpu` is the only way onto the CPU, and with neither a
CUDA device nor `--cpu` it stops with an error.

Start:  python -m videoitg_tpu_torch.cli.serve --model ckpt/ --quantize act8 \\
            --num-frames 512 --target-fps 1 --warmup --port 8080
Smoke:  python -m videoitg_tpu_torch.cli.serve --preset tiny --random-init \\
            --cpu --port 8080
        curl -s localhost:8080/select -d '{"video_path": "clip.mp4",
            "prompt": "when does the car turn left?", "topk": 8}'

`--model DIR` reads an HF-format VideoITG checkpoint (safetensors or .bin,
videoitg_tpu_config.json, a tokenizer for transformers' AutoTokenizer), or a
serving checkpoint (`videoitg-torch-select --export-serving`), which loads
already quantised in its saved tier.

Several devices: `--dp/--tp/--sp/--pp` lay the ranks of a torchrun launch
out as a device mesh (parallel/mesh.py), one process per GPU:

  torchrun --nproc-per-node 4 -m videoitg_tpu_torch.cli.serve --tp 4 ...

Rank 0 binds HTTP, decodes, and broadcasts each burst of requests and each
video's uint8 frames (or YUV planes) over the group, so no other rank reads
or decodes a file; every rank runs the engine on the same requests in the
same order (and so keeps the same encoded-video LRU), and rank 0 replies.
/healthz reports the mesh. With `--cpu` the group is gloo, else NCCL.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("videoitg-torch-serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", help="HF-format VideoITG checkpoint directory, or a serving "
                                    "checkpoint (--export-serving)")
    p.add_argument("--preset", default="videoitg-8b")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--num-frames", type=int, default=512)
    p.add_argument("--target-fps", type=float, default=1.0)
    p.add_argument("--dtype", default=None, choices=[None, "bfloat16", "float32"],
                   help="default: bfloat16 on the card, float32 on the CPU")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int4", "act8"])
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh axis: videos, frames and questions split "
                        "over it (multi-GPU serving under torchrun)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel mesh axis (heads/ffn sharding)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis (ring attention over the LM sequence)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (layer-sharded decoder, "
                        "microbatch pipeline)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--decode-workers", type=int, default=2)
    p.add_argument("--decode-ahead", type=int, default=4)
    p.add_argument("--encode-cache", type=int, default=2,
                   help="encoded-video LRU slots: repeat prompts against a "
                        "cached video skip decode+preprocess+tower; a slot holds "
                        "the video's tower features on the device "
                        "([frames, 729, 1152] in the model dtype for VideoITG-8B); "
                        "0 disables")
    p.add_argument("--transfer", default="rgb", choices=["rgb", "yuv420"],
                   help="yuv420: ship native YUV planes (half the "
                        "host->device bytes) and convert on device")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run a synthetic video per bucket "
                        "at startup, so first requests are steady-state")
    p.add_argument("--warmup-buckets", default=None,
                   help="comma list of frame buckets to warm (e.g. '128,256,512'); "
                        "default: the --num-frames bucket")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


class SelectionServer:
    """Queue + scoring worker around a hot SelectionEngine.

    With `group` (a process group spanning every rank of a mesh engine) the
    server of the group's rank 0 leads: its worker broadcasts each burst of
    requests and each decoded video to the other ranks, whose servers run
    `follow()` and score the same burst with no HTTP, queue or decoder of
    their own."""

    def __init__(self, engine, decode_workers: int = 2, decode_ahead: int = 4,
                 encode_cache: int = 2, group=None):
        self.engine = engine
        self.group = group
        self.leader = True
        if group is not None:
            import torch.distributed as dist

            self.leader = dist.get_rank(group) == 0
            self._src = dist.get_global_rank(group, 0)
        self.decode_workers = decode_workers
        self.decode_ahead = decode_ahead
        self.requests: queue.Queue = queue.Queue()
        self.served = 0
        # Encoded-video LRU: the serving pattern is many prompts against one
        # video. The tower never sees the prompt, so repeat requests skip
        # decode + preprocess + tower (engine.EncodedVideo); each slot holds
        # [t_bucket, patches, channels] features on the device, so size the
        # LRU to spare device memory.
        self.encode_cache = encode_cache
        self._cache: dict = {}  # key -> (EncodedVideo, sampled), oldest first
        self.cache_hits = 0
        self._lock = threading.Lock()
        self._worker = None
        if self.leader:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def submit(self, req: dict) -> dict:
        """Blocking submit: returns the response dict (or {"error": ...})."""
        done = threading.Event()
        box: dict = {}
        self.requests.put((req, box, done))
        done.wait()
        return box

    def _drain(self):
        """One item (blocking) plus everything else already queued."""
        batch = [self.requests.get()]
        while True:
            try:
                batch.append(self.requests.get_nowait())
            except queue.Empty:
                return batch

    def close(self) -> None:
        """Stop the scoring worker once it has answered what is queued (and,
        when leading a group, the followers with it), and drop the engine and
        the LRU's slots (the weights and features they hold on the device go
        with them)."""
        if self._worker is not None:
            self.requests.put(None)
            self._worker.join()
        self._cache.clear()
        self.engine = None

    def follow(self) -> None:
        """A follower rank's loop: score every burst the leader shares, until
        the leader closes."""
        while True:
            burst = self._share(None)
            if burst is None:
                return
            self._serve_burst([(req, {}, threading.Event(), key) for req, key in burst])

    def _share(self, obj):
        """The leader's `obj` on every rank of the group (itself alone)."""
        if self.group is None:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        return box[0]

    def _run(self):
        if self.group is not None and self.engine.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.engine.device)  # the thread's collectives' device
        while True:
            batch = self._drain()
            entries = [(req, box, done,
                        self._encode_key(req.get("video_path", ""), req.get("sampling", "eval")))
                       for req, box, done in (e for e in batch if e is not None)]
            self._share([(req, key) for req, _, _, key in entries])
            self._serve_burst(entries)
            if None in batch:  # close() was called
                self._share(None)
                return

    def _serve_burst(self, entries):
        # decode_ahead takes one sampling mode per call: group the burst.
        by_sampling: dict = {}
        for entry in entries:
            by_sampling.setdefault(entry[0].get("sampling", "eval"), []).append(entry)
        for sampling, group in by_sampling.items():
            self._score_group(sampling, group)

    def _encode_key(self, video_path: str, sampling: str):
        try:
            st = os.stat(video_path)
            ident = (os.path.abspath(video_path), st.st_size, int(st.st_mtime))
        except OSError:
            ident = (os.path.abspath(video_path), -1, -1)
        return ident + (self.engine.num_frames, self.engine.target_fps, sampling)

    def _cache_get(self, key):
        entry = self._cache.pop(key, None)
        if entry is not None:
            self._cache[key] = entry  # LRU: re-insert as newest
        return entry

    def _cache_put(self, key, entry):
        self._cache[key] = entry
        while len(self._cache) > self.encode_cache:
            self._cache.pop(next(iter(self._cache)))

    def _shared_video(self, dec):
        """(frames, sampled, error message) of one decoded video on every
        rank: the leader broadcasts its uint8 frames (or YUV planes) over
        the group, on the engine's device."""
        error = None if dec is None or dec.error is None else \
            f"{type(dec.error).__name__}: {dec.error}"
        if self.group is None:
            return dec.frames, dec.sampled, error
        import numpy as np
        import torch
        import torch.distributed as dist

        from videoitg_tpu_torch.data.video import YUVFrames

        header = None
        if self.leader:
            planes = [] if error else (list(dec.frames) if isinstance(dec.frames, YUVFrames)
                                       else [dec.frames])
            header = {"error": error, "yuv": isinstance(dec.frames, YUVFrames),
                      "shapes": [p.shape for p in planes], "sampled": dec.sampled}
        header = self._share(header)
        if header["error"]:
            return None, None, header["error"]
        device = self.engine.device
        if self.leader:
            tensors = [torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in planes]
        else:
            tensors = [torch.empty(shape, dtype=torch.uint8, device=device)
                       for shape in header["shapes"]]
        for t in tensors:
            dist.broadcast(t, src=self._src, group=self.group)
        frames = YUVFrames(*tensors) if header["yuv"] else tensors[0]
        return frames, header["sampled"], None

    def _decoded(self, misses, sampling):
        """(frames, sampled, error) for each miss, in order. The leader
        decodes ahead on host threads (uploading and resizing there too when
        it serves alone); a follower receives the leader's frames."""
        if not self.leader:
            for _ in misses:
                yield self._shared_video(None)
            return
        from videoitg_tpu_torch.data.prefetch import decode_ahead

        items = [(key, req.get("video_path", ""), None) for key, req, _, _ in misses]
        for dec in decode_ahead(
                items, num_frames=self.engine.num_frames,
                target_fps=self.engine.target_fps,
                sampling=sampling, pix_fmt=self.engine.transfer,
                workers=self.decode_workers, ahead=self.decode_ahead,
                post=self.engine.preprocess_ahead if self.group is None else None):
            yield self._shared_video(dec)

    def _respond(self, req, box, done, enc, sampled):
        try:
            scores = self.engine.score_encoded(enc, [req["prompt"]])[0]
            index, logits = self.engine.rank_frames(scores, sampled)
            box.update({
                "index": index, "logits": logits, "num_frames": 1,
                "contexts": req["prompt"],
                "video_path": req.get("video_path", ""),
                "doc_id": req.get("doc_id"),
                "selected": sorted(index[: int(req.get("topk", 32))]),
            })
            with self._lock:
                self.served += 1
        except Exception as e:  # per-request isolation
            box["error"] = f"{type(e).__name__}: {e}"
        finally:
            done.set()

    def _score_group(self, sampling: str, group):
        misses = []
        for req, box, done, key in group:
            entry = self._cache_get(key) if self.encode_cache else None
            if entry is not None:
                with self._lock:
                    self.cache_hits += 1
                self._respond(req, box, done, *entry)
            else:
                misses.append((key, req, box, done))

        # Decode ahead across the whole queued burst: host decode, upload and
        # resize of request i+1 overlap the card scoring request i.
        for (key, req, box, done), (frames, sampled, error) in zip(
                misses, self._decoded(misses, sampling)):
            if error is not None:
                box["error"] = error
                done.set()
                continue
            try:
                enc = self.engine.encode_video(frames)
            except Exception as e:  # per-request isolation
                box["error"] = f"{type(e).__name__}: {e}"
                done.set()
                continue
            if self.encode_cache:
                self._cache_put(key, (enc, sampled))
            self._respond(req, box, done, enc, sampled)


def make_handler(server: SelectionServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                health = {"ok": True, "pending": server.requests.qsize(),
                          "served": server.served, "encode_cache_hits": server.cache_hits}
                if server.engine.mesh is not None:  # {axis: size} of a mesh engine
                    from videoitg_tpu_torch.parallel.mesh import mesh_shape

                    health["mesh"] = mesh_shape(server.engine.mesh)
                self._reply(200, health)
            elif self.path == "/stats":
                self._reply(200, server.engine.timer.summary())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/select":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if "video_path" not in req or "prompt" not in req:
                    raise ValueError("need video_path and prompt")
            except Exception as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            out = server.submit(req)
            self._reply(200 if "error" not in out else 500, out)

    return Handler


def build_engine(args, device, mesh=None):
    """The hot engine on `device` from the parsed flags, on `mesh` if given."""
    import torch

    from videoitg_tpu_torch.cli._model_loading import load_grounding_components
    from videoitg_tpu_torch.engine import SelectionEngine

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.dtype or ("bfloat16" if device.type == "cuda" else "float32")]
    params, cfg, tokenizer = load_grounding_components(
        args.model, args.preset, args.random_init, dtype, device, quantize=args.quantize,
        tool="videoitg-torch-serve")
    return SelectionEngine(params, cfg, tokenizer, device=device, dtype=dtype, mesh=mesh,
                           num_frames=args.num_frames, target_fps=args.target_fps,
                           transfer=args.transfer)


def warmup(engine, buckets) -> None:
    """Before accepting traffic: build the kernels (on the card) and run one
    synthetic video of each frame bucket through decode, preprocess, tower and
    LM, so that the first request pays neither the build nor first-use set-up."""
    import tempfile

    from videoitg_tpu_torch.data.video import write_test_video

    if engine.device.type == "cuda":
        from videoitg_tpu_torch.ops import _build

        _build.library()
    with tempfile.TemporaryDirectory() as d:
        for n in buckets:
            v = write_test_video(os.path.join(d, f"warm{n}.mp4"), 96, 64, max(int(n), 8), 10, 12)
            engine.select_from_file(v, "warmup", sampling="eval")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from videoitg_tpu_torch.cli._model_loading import resolve_device
    from videoitg_tpu_torch.parallel.mesh import leave_mesh, open_cli_mesh

    try:
        device, mesh = open_cli_mesh(args, "videoitg-torch-serve")
        if device is None:
            device = resolve_device(args.cpu, "videoitg-torch-serve", "--cpu")
        engine = build_engine(args, device, mesh)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    if args.warmup or args.warmup_buckets:
        buckets = ([int(x) for x in args.warmup_buckets.split(",")]
                   if args.warmup_buckets else [args.num_frames])
        print(f"[videoitg-torch-serve] warming up buckets {buckets}...", file=sys.stderr)
        warmup(engine, buckets)  # every rank of a mesh, in step
    group = None
    if mesh is not None:
        import torch.distributed as dist

        group = dist.group.WORLD
    server = SelectionServer(engine, decode_workers=args.decode_workers,
                             decode_ahead=args.decode_ahead,
                             encode_cache=args.encode_cache, group=group)
    if not server.leader:
        server.follow()
        server.close()
        leave_mesh(mesh)
        return 0
    if group is not None:
        import signal

        def _stop(*_):
            raise KeyboardInterrupt
        signal.signal(signal.SIGTERM, _stop)  # a stopped leader stops its followers too
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"[videoitg-torch-serve] listening on {args.host}:{httpd.server_address[1]}",
          file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
        leave_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
