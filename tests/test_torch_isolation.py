"""The PyTorch port stands alone: no module of scannertools_tpu_torch, and
not chip_smoke.py, imports jax, flax or the JAX package, and the port runs
its main path in a process that never loads jax."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "scannertools_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                  "scannertools_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    """Root module names of every absolute import in the file (relative
    imports stay inside the package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_are_found():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("scannertools_tpu_torch", "runtime",
                        "executor.py") in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    # exact root names: scannertools_tpu_torch is not scannertools_tpu
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_main_path_runs_without_loading_jax(tmp_path):
    code = f"""
import sys
import numpy as np, cv2
path = {str(tmp_path / "v.mp4")!r}
w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 48))
for i in range(60):
    f = np.zeros((48, 64, 3), np.uint8)
    f[:, :] = [(200, 40, 40), (40, 200, 40)][i >= 30]
    f[:, (2 * i) % 56:(2 * i) % 56 + 8] = 255
    w.write(f)
w.release()
import scannertools_tpu_torch as st
sc = st.Client(db_path={str(tmp_path / "db")!r}, device="cpu")
frame = sc.io.Input([st.NamedVideoStream(sc, "v", path=path)])
bounds = sc.ops.ShotBoundaries(histograms=sc.ops.Histogram(frame=frame))
out = st.NamedStream(sc, "shots")
sc.run(sc.io.Output(bounds, [out]), st.PerfParams.manual(work_packet_size=16),
       cache_mode=st.CacheMode.Overwrite)
assert next(out.load(rows=[0])) == [30], next(out.load(rows=[0]))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {sorted(FORBIDDEN)!r})
assert not loaded, loaded
print("PORT_ALONE_OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "PORT_ALONE_OK" in res.stdout, (
        res.stdout + res.stderr)
