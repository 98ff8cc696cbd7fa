"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU. It sets
up (imports, CUDA context, the program's kernels, weights and frames drawn
from the seed, one warm packet), drives ``Client.run`` over clips for
``--seconds``, checks a sample of the stored rows against the plain
reference, and prints one JSON object as its last line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``). Every number the check compares is printed beside its limit, as the
last lines of standard error and under "checks" in the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may pull in JAX."""
    for var, sub in (("SCANNERTOOLS_TPU_BUILD", "native"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START,
                           log=lambda m: print(m, file=sys.stderr,
                                               flush=True))
    found = harness.forbidden_modules()
    if found:
        print("loaded modules of JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # no result line: the run failed
        traceback.print_exc()
        sys.exit(1)
