#!/usr/bin/env python3
"""The two readings a limit of `correct` is set from, on the card, at a
cell's own sizes: the numbers of benchmark/check.py for the program as its
configuration states it (sound runs), and for its control, the program's own
path in the precision below (the configuration's "control"), each against
the plain reference, seed by seed, in one process.

    python3 benchmark/tools/readings.py --workload itg8b.select512 \
        --seeds 101 102 103 --control-seeds 101 102 103

For each seed: the cell's traffic and weights from the seed, the cell's
client for the requests that the check samples, the program's scores;
again with the control on the control seeds; then the reference. Also the
gap between the reference's scores of one sampled request and of the same
video under another request's instruction (how far the instruction moves
the scores), and the numbers of two faults worked out from the sound
scores: a stale answer (a video's first answer for each of its questions)
and a wrong instruction. One JSON line a seed on standard output and in
chiprun_out/, and the scores themselves in an .npz beside it.
Benchmark runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["VIDEOITG_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "videoitg_tpu_torch")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.check import gaps, logits_of, pick_sample, reference_scores  # noqa: E402
from benchmark.inputs import derive, make_traffic  # noqa: E402
from benchmark.manifest import Manifest, reference_module  # noqa: E402
from benchmark.port import DTYPES, build_engine  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

REQUESTS = {"select": 4, "reuse": 12}  # requests driven so that the sample can be drawn


def program_scores(cfg, mix, client_cls, traffic, seed, device, tier=None, kernels=None):
    state = make_weights(cfg["model"], derive(seed, "weights"), device, DTYPES[cfg["dtype"]],
                         reference_module(cfg))
    engine = build_engine(cfg, state, device, tier=tier, kernels=kernels)
    del state
    client = client_cls(engine, traffic)
    done = [client.next() for _ in range(REQUESTS[mix["kind"]])]
    del client, engine
    gc.collect()
    torch.cuda.empty_cache()
    return done


def control_scores(cfg, mix, client_cls, traffic, seed, device, pairs):
    """The control's scores of the sampled (video, instruction) pairs: the
    program's own path in the precision below (the configuration's control
    `tier` and `kernels`), or the reference in it (`reference_tier`)."""
    ctl = cfg["control"]
    if "reference_tier" in ctl:
        return reference_scores(dict(cfg, tier=ctl["reference_tier"]), seed, traffic.videos,
                                pairs, device)
    done = program_scores(cfg, mix, client_cls, traffic, seed, device, tier=ctl["tier"],
                          kernels=ctl["kernels"])
    return [r.scores for r in pick_sample(done, seed, **mix["check"])]


def faults(done, sample, pairs_ref, other_ref):
    """Numbers of two planted faults, worked out from sound scores: each
    sampled request answered with its video's first answer (a stale
    answer), and the first sampled request answered under another
    request's instruction (a wrong instruction)."""
    first = {}
    for r in done:
        first.setdefault(r.group, r)
    out = {"wrong": gaps([sample[0].scores], [other_ref])}
    if any(first[r.group] is not r for r in sample):
        out["stale"] = gaps([first[r.group].scores for r in sample], pairs_ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    man = Manifest()
    wl = man.workload(args.workload)
    cfg, mix = man.config(wl), man.mix(wl)
    device = torch.device("cuda:0")
    client_cls = man.client(mix)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"readings_{args.workload}.jsonl")
    for seed in args.seeds:
        t0 = time.perf_counter()
        traffic = make_traffic(mix, seed, device)
        done = program_scores(cfg, mix, client_cls, traffic, seed, device)
        sample = pick_sample(done, seed, **mix["check"])
        pairs = [(r.video, r.instruction) for r in sample]
        other = [r.instruction for r in done if r.instruction != sample[0].instruction][0]
        ref = reference_scores(cfg, seed, traffic.videos, pairs + [(sample[0].video, other)],
                               device)
        want, other_ref = ref[: len(sample)], ref[-1]
        row = {"workload": args.workload, "seed": seed,
               "program": gaps([r.scores for r in sample], want),
               "instruction": gaps([other_ref], [want[0]])}
        row.update(faults(done, sample, want, other_ref))
        arrays = {"program": np.stack([r.scores for r in sample]), "reference": np.stack(want),
                  "other_reference": other_ref}
        if seed in args.control_seeds:
            control = control_scores(cfg, mix, client_cls, traffic, seed, device, pairs)
            row["control"] = gaps(control, want)
            arrays["control"] = np.stack(control)
        row["logit_spread"] = float(np.std(logits_of(want[0])))
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")
        np.savez(os.path.join(out_dir, f"readings_{args.workload}_{seed}.npz"), **arrays)
        del traffic, done, sample, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
