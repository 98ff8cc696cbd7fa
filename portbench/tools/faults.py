"""The faults a cell can have, planted in the program, and a run of the
harness with each: the check has to find every one (``correct`` false).

    python3 -m portbench.tools.faults --workload face_embedding.crowd \
        --seeds 21 22 23 --seconds 5

Prints one JSON line a fault and seed: each number compared, its limit,
and ``correct``. The faults: an answer altered where it is made, half of
the batch left out, a step that returns its first answer again.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _stale(fn):
    """The first call's answer, returned again for every later call."""
    first = []

    def call(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return call


def _embed_altered(fn):
    def call(state, crops):
        out = fn(state, crops)
        out = out + 0.05 * torch.ones_like(out)
        return out / out.norm(dim=-1, keepdim=True)
    return call


def _embed_half(fn):
    """Every other crop of the batch left out (zero), so that the faces
    are hit wherever the batch keeps its padding."""
    def call(state, crops):
        out = fn(state, crops).clone()
        out[1::2] = 0
        return out
    return call


def _maps_half(fn):
    def call(state, x):
        heat, paf = fn(state, x)
        heat, paf = heat.clone(), paf.clone()
        heat[x.shape[0] // 2:] = 0
        paf[x.shape[0] // 2:] = 0
        return heat, paf
    return call


def _people_moved(fn):
    def call(*a):
        out = []
        for score, kp in fn(*a):
            kp = kp.copy()
            kp[kp[:, 2] > 0, 0] += 1.0
            out.append((score, kp))
        return out
    return call


# name -> (configuration, module of the program, function, wrapper)
FAULTS = {
    "face answer altered": ("face_embedding", "models.facenet", "embed",
                            _embed_altered),
    "face half the crops left out": ("face_embedding", "models.facenet",
                                     "embed", _embed_half),
    "face detections stale": ("face_embedding", "models.mtcnn",
                              "detect_batch", _stale),
    "pose answer altered": ("pose_detection", "models.pose", "group_people",
                            _people_moved),
    "pose half the frames left out": ("pose_detection", "models.pose",
                                      "body_maps", _maps_half),
}


class planted:
    """Context: the fault ``name`` planted in the program."""

    def __init__(self, name: str):
        _, module, self.attr, wrap = FAULTS[name]
        self.mod = importlib.import_module(f"scannertools_tpu_torch.{module}")
        self.real = getattr(self.mod, self.attr)
        self.wrapped = wrap(self.real)

    def __enter__(self):
        setattr(self.mod, self.attr, self.wrapped)

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    config = {w["name"]: w["config"]
              for w in bench["workloads"]}[args.workload]
    for name in sorted(n for n, f in FAULTS.items() if f[0] == config):
        for seed in args.seeds:
            with planted(name):
                out = harness.run_cell(bench, args.workload, seed,
                                       args.seconds, False, args.device)
            print(json.dumps({"workload": args.workload, "fault": name,
                              "seed": seed,
                              "correct": out["result"]["correct"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
