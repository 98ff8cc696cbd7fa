"""One run of one cell: set up, measure a window, check, report.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json``, ``traffic/<cell>.json``,
``reference/<config>.py`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

from . import drive, roofline

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "scannertools_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: str) -> dict:
    """The files a cell resolves to -> {"cell", "config", "traffic",
    "reference", "metrics": {name: path}}; raises KeyError for an unknown
    cell."""
    wl = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    metrics = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", [cell]):
            metrics[m["name"]] = HERE / "metrics" / f"{m['name']}.py"
    return {"cell": wl, "config": HERE.parent / cfg["file"],
            "traffic": HERE / "traffic" / f"{wl['traffic']}.json",
            "reference": HERE / "reference" / f"{wl['config']}.py",
            "metrics": metrics}


def load_metric(path: Path) -> types.ModuleType:
    """A metric's reader from its file (a name may hold dots, as
    ``frames_per_s.pose`` does)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``scannertools_tpu_torch`` is not ``scannertools_tpu``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _substitute(params, paths: dict):
    """"@<model>" values -> the path of that model's weights file."""
    if isinstance(params, dict):
        return {k: _substitute(v, paths) for k, v in params.items()}
    if isinstance(params, str) and params.startswith("@"):
        return paths[params[1:]]
    return params


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _spans(sc, names, anchor_t: float, anchor_name: str) -> dict:
    """The program's spans of ``names`` -> {name: [(start, end)]} on this
    process's perf_counter clock, placed by the anchor event recorded at
    ``anchor_t``."""
    anchor = sc.profiler.intervals(anchor_name)[-1]["ts"] / 1e6
    off = anchor_t - anchor
    out = {}
    for name in names:
        out[name] = [(off + iv["ts"] / 1e6, off + (iv["ts"] + iv["dur"]) / 1e6)
                     for iv in sc.profiler.intervals(name)]
    return out


class Trace:
    """The card's activity over the window, from torch.profiler: kernel
    and copy intervals on this process's perf_counter clock."""

    def __init__(self):
        self.prof = None
        self.events = []

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.unix_minus_perf = time.time() - time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        unix_minus_perf = self.unix_minus_perf
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e9 - unix_minus_perf
            self.events.append((e.name(), start, e.duration_ns() / 1e9))
        self.events.sort(key=lambda x: x[1])

    def window(self, t0: float, t1: float) -> list:
        return [e for e in self.events if t0 <= e[1] < t1]


def busy_intervals(events) -> list:
    """Merged [start, end) intervals in which some device activity ran."""
    out = []
    for _, s, d in events:
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _breakdown(events, busy, spans, t0, t1) -> dict:
    by_name = {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    gaps = []
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inside = sorted({n for n, iv in spans.items()
                         for s, e in iv if s <= mid < e})
        named.append(["+".join(inside) or "no program span", b - a])
    return {"device_ops": [[n[:160], d] for n, d in ops],
            "idle_gaps": named}


def _measure(sc, cfg, traffic, pool_host, rng, seconds, tracer, prefix,
             log):
    """One window over clips drawn from ``rng`` -> SimpleNamespace(t0, t1,
    packets, frames, rec, offsets): the window's ends, the packets stored
    in it ((clip, first row, rows)) and their frames, the recorder, and
    each clip's first pool frame. A ``tracer`` records the card's
    activity over it."""
    clip_n = traffic["clip_frames"]
    n_clips = 2 + int(seconds * traffic["max_frames_per_s"] / clip_n)
    offsets = rng.integers(0, len(pool_host), n_clips)
    rec = drive.Recorder(drive.columns(cfg), seconds)
    clips = drive.clip_streams(sc, pool_host, offsets, clip_n, rec,
                               prefix=prefix)
    bench_cls = drive.runner(cfg, traffic.get("perf"), rec)
    if tracer:
        tracer.start()
    cpu0 = time.process_time()
    try:
        bench_cls(sc).execute(videos=clips, cache=False)
    except drive.WindowClosed:
        pass
    cpu_s = time.process_time() - cpu0
    if tracer:
        tracer.stop()
    window = rec.window()
    if window is None:
        raise RuntimeError("the clips ran out before the window closed: "
                           "raise max_frames_per_s in the traffic file")
    t0, t1, packets = window
    log(f"window {prefix}: {t1 - t0:.3f} s, {len(packets)} packets of "
        f"{sorted({n for _, _, n in packets})} frames, process cpu "
        f"{cpu_s:.3f} s, load {os.getloadavg()}")
    return types.SimpleNamespace(
        t0=t0, t1=t1, packets=packets, rec=rec, tracer=tracer,
        offsets={c.name: int(o) for c, o in zip(clips, offsets)},
        frames=sum(n for _, _, n in packets))


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             overrides: dict = None, log=None) -> dict:
    """One run -> {"result": the last line's object, "checks": {name:
    [value, limit]}}. ``overrides`` merges into the configuration and
    traffic ({"config": {...}, "traffic": {...}}) for tests at small
    sizes.

    An untraced run measures one window. A traced run measures two: the
    first untraced, for the metrics read on the host clock and from the
    program's spans, then one under torch.profiler, for those read from
    the card's activity."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: None)
    files = cell_files(bench, cell)
    overrides = overrides or {}
    cfg = _merge(load_json(files["config"]), overrides.get("config"))
    traffic = _merge(load_json(files["traffic"]), overrides.get("traffic"))
    ref = importlib.import_module(f"portbench.reference.{cfg['name']}")
    metric_mods = {n: load_metric(path)
                   for n, path in files["metrics"].items()}
    on_card = device.startswith("cuda")

    import scannertools_tpu_torch as st

    if on_card:
        from scannertools_tpu_torch.kernels import build

        build.build_all()
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    pool = drive.draw_pool(traffic, gen, device)
    # the reference's own work (the draw and the heads set over the pool)
    # is timed apart and left out of setup_s
    t_ref = time.perf_counter()
    state = ref.build(cfg, traffic, pool, gen, device)
    _sync(device)
    ref_build_s = time.perf_counter() - t_ref
    pool_host = pool.cpu().numpy()
    del pool
    _, h, w, _ = pool_host.shape
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        paths = ref.write_weights(state, work, cfg)
        cfg["op_params"] = _substitute(cfg["op_params"], paths)
        state_host = {k: v.cpu() for k, v in state.items()}
        del state
        sc = st.Client(db_path=os.path.join(work, "db"), device=device)
        w_packet = drive.packet_rows(traffic, h, w)
        warm_rec = drive.Recorder(drive.columns(cfg))
        warm = drive.clip_streams(sc, pool_host, [0], w_packet, warm_rec,
                                  prefix="warm")
        drive.runner(cfg, traffic.get("perf"), warm_rec)(sc).execute(
            videos=warm, cache=False)
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start - ref_build_s
        log(f"set-up {setup_s:.3f} s, the reference's build {ref_build_s:.3f}"
            f" s apart, warm packets "
            f"{sorted(warm_rec.chunks.get('warm00000', {}).values())}")

        sc.profiler.count("portbench:window")
        anchor_t = time.perf_counter()
        main = _measure(sc, cfg, traffic, pool_host, rng, seconds, None,
                        "clip", log)
        # a CPU run reads no device metric
        traced = None
        if trace and on_card:
            traced = _measure(sc, cfg, traffic, pool_host, rng, seconds,
                              Trace(), "traced", log)
        _sync(device)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        spans = _spans(sc, ["source:read", "source:upload",
                            "source:wait_slot", "sink:write"]
                       + [f"op:{o}" for o in cfg["host_ops"]]
                       + [f"device:{o}" for o in cfg["device_ops"]],
                       anchor_t, "portbench:window")
        # the program's state goes before the reference runs
        del sc
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        state = {k: v.to(device) for k, v in state_host.items()}

        def rows_of(win, clip, first, n):
            return [{c: ref.parse(c, d) for c, d in
                     win.rec.row(clip, first + i).items()}
                    for i in range(n)]

        def pool_idx(win, clip, first, n):
            return (win.offsets[clip] + np.arange(first, first + n)) \
                % len(pool_host)

        run = types.SimpleNamespace(
            seconds=main.t1 - main.t0, setup_s=setup_s, t0=main.t0,
            t1=main.t1, frames=main.frames, spans=spans,
            host_ops=cfg["host_ops"], flops=None, calls={}, events=None,
            busy_s=None, window_s=None)
        if traced:
            idx = np.concatenate([pool_idx(main, *p) for p in main.packets])
            rows = [r for p in main.packets for r in rows_of(main, *p)]
            run.flops = ref.flops(cfg, state, pool_host, idx, rows)

        # the check: a sample of the windows' packets, drawn from the seed:
        # at least check_packets packets, and more, in the seed's order,
        # until check_items answers (faces, people) have been compared or
        # four times check_packets have been checked
        wins = [main] + ([traced] if traced else [])
        packets = [(win, p) for win in wins for p in win.packets]
        order = [packets[i] for i in rng.permutation(len(packets))]
        got, want, calls, picks = [], [], {}, []
        for win, (clip, first, n) in order:
            k = len(picks) / traffic["check_packets"]
            if k >= 4 or k >= 1 and sum(len(g[cfg["output_column"]])
                                        for g in got) >= traffic["check_items"]:
                break
            picks.append((clip, first))
            frames = torch.from_numpy(
                pool_host[pool_idx(win, clip, first, n)]).to(device)
            prog = rows_of(win, clip, first, n)
            out = ref.reference(cfg, state, frames, prog, bounds=trace)
            got += prog
            want += out["frames"]
            for fam, ms in out["calls"].items():
                calls.setdefault(fam, []).extend(ms)
        numbers = ref.compare(cfg, got, want, (h, w))
        limits = cfg["limits"]
        checks = {k: [numbers[k], limits[k]] for k in limits}
        correct = bool(picks) and all(v <= lim for v, lim in checks.values())

        run.calls = {f: float(np.mean(v)) for f, v in calls.items() if v}
        log(f"check {time.perf_counter() - t_check:.3f} s")
        result_device = {"platform": "gpu" if on_card else device,
                         "kind": torch.cuda.get_device_name()
                         if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}
        if on_card:
            result_device["power_limit"] = roofline.power_limit()
        breakdown = None
        if traced:
            t0, t1 = traced.t0, traced.t1
            events = traced.tracer.window(t0, t1)
            busy = busy_intervals(events)
            run.events = events
            run.busy_s = sum(min(e, t1) - s for s, e in busy)
            run.window_s = t1 - t0
            result_device["busy_s"] = run.busy_s
            result_device["window_s"] = run.window_s
            if events:
                breakdown = _breakdown(events, busy, spans, t0, t1)
        metrics = {}
        for m in bench["per_layer"] if trace else bench["end_to_end"]:
            mod = metric_mods.get(m["name"])
            value = None if mod is None else mod.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": mod.UNIT}
        attempted = sum(win.frames for win in wins)
        result = {"correct": correct, "attempted": attempted,
                  "failed": 0 if correct else attempted,
                  "metrics": metrics, "device": result_device}
        if breakdown:
            result["breakdown"] = breakdown
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        log(f"window {main.frames} frames, check "
            f"{sum(len(g[cfg['output_column']]) for g in got)} "
            f"items over {len(got)} frames: {numbers}")
        return {"result": result, "checks": checks}
    finally:
        shutil.rmtree(work, ignore_errors=True)
