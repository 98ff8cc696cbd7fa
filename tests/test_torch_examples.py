"""The repo's examples, unedited, under both packages: each runs once as
written for the JAX package and once on the port, through
``scannertools_tpu_torch/tools/jax_alias.py`` (the name
``scannertools_tpu`` resolved to the port; nothing of the JAX package
imported). Each run is its own subprocess, since both packages cannot
hold one name in one process; the two of a case run side by side, each
on one thread (the suite's workers already take every core, and a
thread pool spun up for small operations stalls when they share them).

The input is a 96-frame 320x240 mp4 that cv2 writes, four shots of 24
frames with a moving bar. The runs take default weights (each package's
own draw of the JAX package's ``init_*(PRNGKey(0))``), and one npz that
the JAX package's ``save_params`` wrote, passed through the example's
weights argument: MTCNN's classifier biases set so faces pass its
thresholds, OpenPose's last-stage output layers scaled so people do, a
FaceNet and an SSD draw from PRNGKey(1).

The stored streams are loaded by each package's ``.load()`` (stdout
differs: ``sc.summarize()``) and compared: shot cuts equal ([24, 48,
72]), counts and labels equal, floats within 1e-4 (boxes and keypoints
normalized to [0, 1], scores in [0, 1], embeddings of unit norm; the
nets' float32 sums run in other orders). Detections whose scores tie
within 1e-4 may come in another order, and where NMS or a cap breaks
such a tie the other way, another of the tied rows is kept: both are
counted by ``compare_detections`` (moved, flipped), which fails on any
row that ties no other. Flat regions of the clip give MTCNN's boxes and
SSD's anchors equal scores: on the face npz, a row of 0.97 boxes along
frame 90's top edge kept 19 rows in both packages in runs alone and 22
against 19 in one run of the whole suite (3 flipped); SSD's default run
moved 12 rows and flipped none. The port's ``Client()`` means
CUDA and raises without it: the port's subprocess patches the device to
the CPU, and this file alone does. Faster R-CNN and Mask R-CNN X-101 run
under ``slow`` (tests/test_torch_examples_detection.py); on the card all
six run in ``chip_smoke.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
FLOAT_ATOL = 1e-4
CUTS = [24, 48, 72]

# the port's side: the device patched to the CPU, then the script under
# the alias
PORT_BOOT = """
import sys
import torch
torch.set_num_threads(1)
import scannertools_tpu_torch.client as client
resolve = client._resolve_device
client._resolve_device = lambda d: resolve("cpu" if d is None else d)
from scannertools_tpu_torch.tools.jax_alias import run
run(sys.argv[1], sys.argv[2:])
"""


@pytest.fixture(scope="session")
def example_video(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("examples") / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                        (320, 240))
    colors = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40)]
    for i in range(96):
        f = np.zeros((240, 320, 3), np.uint8)
        f[:] = colors[i // 24][::-1]
        x = (i * 3) % 300
        f[60:180, x:x + 20] = 255
        w.write(f)
    w.release()
    return path


def _launch(pkg: str, workdir: str, script: str, args):
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, SCANNERTOOLS_TPU_DB=os.path.join(workdir, "db"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    path = os.path.join(EXAMPLES, script)
    if pkg == "jax":
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_"
                            "thread_eigen=false intra_op_parallelism_threads"
                            "=1").strip()
        cmd = [sys.executable, path, *args]
    else:
        cmd = [sys.executable, "-c", PORT_BOOT, path, *args]
    log = open(os.path.join(workdir, "log.txt"), "w")
    return subprocess.Popen(cmd, cwd=workdir, env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


def run_both(tmp_path, script: str, *args, timeout: float = 600):
    """The example under each package, side by side -> {pkg: db path}."""
    procs = {pkg: _launch(pkg, str(tmp_path / pkg), script,
                          [a.replace("{pkg}", str(tmp_path / pkg))
                           for a in args])
             for pkg in ("jax", "port")}
    for pkg, (p, log) in procs.items():
        try:
            rc = p.wait(timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
            log.close()
        out = open(os.path.join(str(tmp_path / pkg), "log.txt")).read()
        assert rc == 0, f"{pkg} {script}: rc {rc}\n{out[-3000:]}"
    return {pkg: str(tmp_path / pkg / "db") for pkg in procs}


def load(pkg: str, db: str, names, rows=None):
    """{name: rows} of the named streams, loaded by ``pkg``'s ``.load()``
    (``rows``: those rows alone, as the shot examples read their one
    row)."""
    if pkg == "jax":
        import scannertools_tpu as m

        sc = m.Client(db_path=db)
    else:
        import scannertools_tpu_torch as m

        sc = m.Client(db_path=db, device="cpu")
    return {n: [plain(r) for r in m.NamedStream(sc, n).load(rows=rows)]
            for n in names}


def plain(x):
    """A stored row -> lists, dicts, numpy arrays and numbers, whichever
    package's types it holds."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "pose_keypoints") and hasattr(x, "_kp"):
        return {"score": float(x._score), "kp": np.asarray(x._kp)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def compare(got, want, where="row", atol=FLOAT_ATOL):
    """Structure, counts, ints and strings equal; floats within atol."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            compare(got[k], want[k], f"{where}.{k}", atol)
    elif isinstance(want, list):
        assert isinstance(got, list), where
        assert len(got) == len(want), f"{where}: {len(got)} rows " \
            f"against {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, f"{where}[{i}]", atol)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert abs(got - want) <= atol, (where, got, want)
    else:
        assert got == want, (where, got, want)


def _score(row):
    if isinstance(row, dict):
        return row["score"] if "score" in row else _score(row.get("bbox"))
    return None


def _agrees(got, want, atol) -> bool:
    try:
        compare(got, want, atol=atol)
    except AssertionError:
        return False
    return True


def pair_rows(got, want, atol=FLOAT_ATOL):
    """A frame's detections in both packages -> (pairs [(got index, want
    index)], got rows unpaired, want rows unpaired). A want row pairs with
    the first unpaired got row of a score within atol that agrees with it
    (its own place first): rows of tied scores may come in either order,
    since the sort of a near-tie follows float noise."""
    pairs, used = [], set()
    for i, w in enumerate(want):
        ties = [j for j in range(len(got)) if j not in used
                and abs(_score(got[j]) - _score(w)) <= atol]
        pick = next((j for j in ([i] if i in ties else []) + ties
                     if _agrees(got[j], w, atol)), None)
        if pick is not None:
            used.add(pick)
            pairs.append((pick, i))
    paired_w = {i for _, i in pairs}
    return (pairs, [j for j in range(len(got)) if j not in used],
            [i for i in range(len(want)) if i not in paired_w])


def _tied(rows, k, atol) -> bool:
    """Row k's score ties, within atol, another row's of its frame."""
    return any(abs(_score(r) - _score(rows[k])) <= atol
               for j, r in enumerate(rows) if j != k)


def compare_detections(got, want, atol=FLOAT_ATOL):
    """Frames of detections (rows with a score) -> (pairs a frame, rows a
    near-tie moved, rows that flipped). Paired rows agree, and the paired
    rows' scores come in the same order in both packages; a row left
    unpaired must tie another row's score in its frame (a near-tie that
    NMS or a cap broke the other way, so another of the tied rows was
    kept); any other difference fails."""
    assert len(got) == len(want), (len(got), len(want))
    all_pairs, moved, flipped = [], 0, 0
    for f, (g, w) in enumerate(zip(got, want)):
        pairs, only_g, only_w = pair_rows(g, w, atol)
        for j in only_g:
            assert _tied(g, j, atol), f"frame {f}: port row {j} {g[j]}"
        for i in only_w:
            assert _tied(w, i, atol), f"frame {f}: JAX row {i} {w[i]}"
        in_got_order = sorted(pairs)
        np.testing.assert_allclose(
            [_score(g[j]) for j, _ in in_got_order],
            [_score(w[i]) for _, i in sorted(pairs, key=lambda p: p[1])],
            rtol=0, atol=atol, err_msg=f"frame {f}: order")
        moved += sum(j != i for j, i in pairs)
        flipped += len(only_g) + len(only_w)
        all_pairs.append(pairs)
    return all_pairs, moved, flipped


def compare_runs(dbs, names, rows=None, aligned=(), atol=FLOAT_ATOL):
    """Load ``names`` from both runs and compare them. A stream of
    detections (rows with a score) is compared by ``compare_detections``,
    and each stream of ``aligned`` row by row over the same pairs; others
    by ``compare``. Returns the port's rows, and under "moved" and
    "flipped" the counts of rows a near-tie moved or flipped, per
    stream."""
    got = load("port", dbs["port"], names, rows)
    want = load("jax", dbs["jax"], names, rows)
    moved, flipped = {}, {}
    pairs = None
    for n in names:
        g, w = got[n], want[n]
        assert len(g) == len(w), (n, len(g), len(w))
        if n in aligned and pairs is not None:
            for f, (gf, wf, p) in enumerate(zip(g, w, pairs)):
                for j, i in p:
                    compare(gf[j], wf[i], f"{n}[{f}][{i}]", atol)
        elif any(_score(r) is not None for f in w for r in (
                f if isinstance(f, list) else [])):
            pairs, moved[n], flipped[n] = compare_detections(g, w, atol)
        else:
            compare(g, w, n, atol)
    got["moved"], got["flipped"] = moved, flipped
    return got


def test_plain_and_compare_catch_a_difference():
    """The comparison is not vacuous: a count, a label or a float past
    the tolerance fails it; rows of tied scores may swap, rows of
    scores apart may not."""
    row = [{"x1": 0.5, "label": 3}, {"x1": 0.25, "label": 1}]
    compare(row, [dict(r) for r in row])
    for bad in ([row[0]], [{"x1": 0.5, "label": 2}, row[1]],
                [{"x1": 0.5 + 2 * FLOAT_ATOL, "label": 3}, row[1]]):
        with pytest.raises(AssertionError):
            compare(bad, row)
    tied = [{"score": 0.5, "x1": 0.1}, {"score": 0.5 + 1e-7, "x1": 0.9}]
    assert compare_detections([tied[::-1]], [tied])[1:] == (2, 0)
    apart = [{"score": 0.5, "x1": 0.1}, {"score": 0.4, "x1": 0.9}]
    with pytest.raises(AssertionError):
        compare_detections([apart[::-1]], [apart])
    # a tied row kept in place of another: a flip; an untied one: a fault
    three = tied + [{"score": 0.3, "x1": 0.5}]
    other = [tied[0], {"score": 0.5, "x1": 0.7}, three[2]]
    assert compare_detections([other], [three])[1:] == (0, 2)
    with pytest.raises(AssertionError):
        compare_detections([three[:2] + [{"score": 0.3, "x1": 0.6}]],
                           [three])


def test_alias_maps_the_name_and_loads_no_jax(tmp_path):
    """Under ``tools/jax_alias.py`` the name ``scannertools_tpu`` and its
    submodules are the port's modules, and nothing of JAX or of the JAX
    package loads."""
    script = tmp_path / "names.py"
    script.write_text(
        "import sys\n"
        "import scannertools_tpu as st\n"
        "from scannertools_tpu.ops.vis_labels import COCO_CATEGORIES\n"
        "import scannertools_tpu.models.weights as w\n"
        "import scannertools_tpu_torch\n"
        "assert st is scannertools_tpu_torch and COCO_CATEGORIES\n"
        "assert w.__name__ == 'scannertools_tpu_torch.models.weights'\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax')))\n")
    out = subprocess.run(
        [sys.executable, "-m", "scannertools_tpu_torch.tools.jax_alias",
         str(script)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_shot_detection_example(tmp_path, example_video):
    dbs = run_both(tmp_path, "shot_detection.py", example_video)
    got = compare_runs(dbs, ["example_shots"], rows=[0])
    assert got["example_shots"] == [CUTS]


def test_elastic_cluster_example(tmp_path, example_video):
    """Two videos, claims mode, each host's own --db."""
    dbs = run_both(tmp_path, "elastic_cluster.py", "--db", "{pkg}/edb",
                   example_video, example_video)
    names = ["shots_0", "shots_1"]
    got = load("port", os.path.join(os.path.dirname(dbs["port"]), "edb"),
               names, [0])
    want = load("jax", os.path.join(os.path.dirname(dbs["jax"]), "edb"),
                names, [0])
    for n in names:
        compare(got[n], want[n], n)
        assert got[n] == [CUTS]


FACE_NAMES = ["demo_faces", "demo_embs", "demo_genders"]


def test_face_example_default_weights(tmp_path, example_video):
    """Default weights keep no face at MTCNN's reference thresholds in
    either package (counts 0 = 0, 4 sampled frames)."""
    dbs = run_both(tmp_path, "face_pipeline.py", example_video)
    got = compare_runs(dbs, FACE_NAMES, aligned=FACE_NAMES[1:])
    assert len(got["demo_faces"]) == 4
    assert sum(len(r) for r in got["demo_faces"]) == 0


@pytest.fixture(scope="module")
def face_npz(tmp_path_factory):
    """The JAX package's MTCNN draw from PRNGKey(1) with each net's
    face-class bias raised (so faces pass 0.45, 0.6 and 0.7), and its
    FaceNet draw from PRNGKey(1), written by its ``save_params``."""
    import jax

    from scannertools_tpu.models import facenet, mtcnn
    from scannertools_tpu.models.weights import save_params

    d = tmp_path_factory.mktemp("face_npz")
    key = jax.random.PRNGKey(1)
    tree = jax.tree_util.tree_map(np.array, mtcnn.init_params(key))
    for net, head in (("pnet", "conv4_1"), ("rnet", "fc2_1"),
                      ("onet", "fc2_1")):
        tree[net][head]["bias"] = np.array([-1.5, 1.5], np.float32)
    paths = (str(d / "mtcnn.npz"), str(d / "facenet.npz"))
    save_params(paths[0], tree)
    save_params(paths[1], facenet.init_params(key))
    return paths


def test_face_example_on_an_npz(tmp_path, example_video, face_npz):
    dbs = run_both(tmp_path, "face_pipeline.py", example_video, *face_npz)
    got = compare_runs(dbs, FACE_NAMES, aligned=FACE_NAMES[1:])
    assert sum(len(r) for r in got["demo_faces"]) > 0
