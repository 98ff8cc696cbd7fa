"""The faults the frcnn_vgg16 cell can have, planted in the program, and a
run of the harness with each: the check has to find every one
(``correct`` false).

    python3 -m portbench.tools.faults_frcnn_vgg16 \
        --workload object_detection.frcnn_vgg16 --seeds 21 22 23 \
        --seconds 5

Prints one JSON line a fault and seed, as ``portbench.tools.faults``
does. The faults: fc7 altered where it is made (the class scores follow
it), half of the RoIs left out of the proposals kept, and a proposal
layer that returns its first answer again.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

from portbench.tools.faults import _stale

ROOT = Path(__file__).resolve().parents[2]


def _fc7_altered(fn):
    """fc7 made 10% larger (its weight and bias scaled by 1.1) for the
    forward, so that every RoI's features, and the class scores on them,
    move."""
    def call(state, *a, **k):
        state = dict(state)
        for key in ("fc7.weight", "fc7.bias"):
            state[key] = state[key] * 1.1
        return fn(state, *a, **k)
    return call


def _rois_half(fn):
    """Every other proposal kept dropped, as if the NMS had not kept it."""
    def call(*a, **k):
        boxes, valid = fn(*a, **k)
        valid = valid.clone()
        valid[:, 1::2] = False
        return boxes, valid
    return call


# name -> (module of the program, function, wrapper)
FAULTS = {
    "frcnn fc7 altered": ("models.faster_rcnn", "apply", _fc7_altered),
    "frcnn half the RoIs left out": ("models.faster_rcnn", "propose_boxes",
                                     _rois_half),
    "frcnn proposals stale": ("models.faster_rcnn", "propose_boxes", _stale),
}


class planted:
    """Context: the fault ``name`` planted in the program."""

    def __init__(self, name: str):
        module, self.attr, wrap = FAULTS[name]
        self.mod = importlib.import_module(f"scannertools_tpu_torch.{module}")
        self.real = getattr(self.mod, self.attr)
        self.wrapped = wrap(self.real)

    def __enter__(self):
        setattr(self.mod, self.attr, self.wrapped)

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="object_detection.frcnn_vgg16")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for name in sorted(FAULTS):
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
