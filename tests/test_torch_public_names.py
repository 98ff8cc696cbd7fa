"""Every public top-level name of each JAX package module has a namesake
in the port's module of the same path, and the names the port added as
thin counterparts (``histogram_reference_np``, ``is_frame_chunk``,
``ssd.postprocess``, ``init_shapes``, ``MaskRCNNModel``, ``ConvBN``,
``pytest_approx_rows``, ``param_shardings``) behave as the JAX
package's.

A public top-level name is a function, class or assignment at a module's
top level whose name does not start with "_" (imports excluded), read
from the JAX source without importing it. The port renamed four; the
table below lists them, each with where its counterpart lives.
"""

import ast
import importlib
import os

import jax
import numpy as np
import pytest
import torch

import scannertools_tpu
from scannertools_tpu.models import ssd as JS
from scannertools_tpu.ops import histogram as JH
from scannertools_tpu.parallel import dryrun as JD
from scannertools_tpu.utils import framechunk as JFC
from scannertools_tpu_torch.models import facenet as PF
from scannertools_tpu_torch.models import maskrcnn as PM
from scannertools_tpu_torch.models import ssd as PS
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import histogram as PH
from scannertools_tpu_torch.parallel import dryrun as PD
from scannertools_tpu_torch.parallel.mesh import Mesh
from scannertools_tpu_torch.utils import framechunk as PFC

JAX_ROOT = os.path.dirname(scannertools_tpu.__file__)

# (JAX module, JAX name) -> (port module, port name): the port's renames
RENAMES = {
    # a test marker: the port's tests need a card, not a TPU
    ("scannertools_tpu.testing", "needs_tpu"):
        ("scannertools_tpu_torch.testing", "needs_cuda"),
    # the profiler's trace context: torch.profiler in place of jax's
    ("scannertools_tpu.runtime.profiler", "jax_trace"):
        ("scannertools_tpu_torch.runtime.profiler", "torch_trace"),
    # folded into moe_apply, whose per-device copies are traced as they run
    ("scannertools_tpu.parallel.expert", "moe_apply_traced"):
        ("scannertools_tpu_torch.parallel.expert", "moe_apply"),
    # the multilevel RoIAlign is a mode of the crop kernel's wrapper
    ("scannertools_tpu.models.maskrcnn", "roi_align_multilevel"):
        ("scannertools_tpu_torch.models.common", "crop_and_resize_levels"),
}


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f),
                                  os.path.dirname(JAX_ROOT))[:-3]
            mod = rel.replace(os.sep, ".")
            out.append(mod[:-len(".__init__")] if mod.endswith(
                ".__init__") else mod)
    return sorted(out)


def _public_names(module: str):
    path = os.path.join(os.path.dirname(JAX_ROOT),
                        *module.split(".")) + ".py"
    if not os.path.exists(path):
        path = path[:-3] + os.sep + "__init__.py"
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_port_namesake(module):
    port = importlib.import_module(
        module.replace("scannertools_tpu", "scannertools_tpu_torch", 1))
    missing = []
    for name in _public_names(module):
        if (module, name) in RENAMES:
            pmod, pname = RENAMES[(module, name)]
            assert hasattr(importlib.import_module(pmod), pname)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{module}: {missing}"


def test_histogram_reference_np_equals_jax():
    frames = np.random.default_rng(0).integers(0, 256, (3, 17, 23, 3),
                                               np.uint8)
    np.testing.assert_array_equal(PH.histogram_reference_np(frames),
                                  JH.histogram_reference_np(frames))


def test_is_frame_chunk():
    chunk = PFC.FrameChunk.from_hwc(torch.zeros(2, 4, 6, 3,
                                                dtype=torch.uint8))
    assert PFC.is_frame_chunk(chunk)
    assert not PFC.is_frame_chunk(np.zeros((2, 4, 6, 3), np.uint8))
    assert not JFC.is_frame_chunk(np.zeros((2, 4, 6, 3), np.uint8))


def test_convbn_is_the_ports_unit():
    assert PF.ConvBN is PF.BasicConv2d


def test_ssd_postprocess_matches_jax():
    """One frame's decode and NMS: labels and the kept set equal, boxes
    and scores within 1e-6 (the SSD parity tests' float bound)."""
    n = PS.anchor_boxes().shape[0]
    rng = np.random.default_rng(2)
    loc = rng.normal(0, 1, (n, 4)).astype(np.float32)
    cls = rng.normal(-3, 2, (n, 91)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(JS.postprocess)(loc, cls)]
    got = [a.numpy() for a in PS.postprocess(torch.from_numpy(loc),
                                             torch.from_numpy(cls))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_maskrcnn_model_variables_and_infer():
    """``MaskRCNNModel(0).variables`` is the default draw in the layout
    the JAX package's ``init_shapes`` gives, and ``infer`` runs the port's
    forward on a variables tree."""
    model = PM.MaskRCNNModel(0, pre_nms=32, post_nms=16, max_det=4,
                             device="cpu")
    flat = PW._flatten(model.variables, leaf=lambda t: t)
    shapes = PW._flatten(PM.init_shapes("R-50-FPN"), leaf=lambda t: t)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    canvas = torch.from_numpy(np.random.default_rng(1).uniform(
        -100, 100, (1, 64, 64, 3)).astype(np.float32))
    boxes, scores, labels, masks = model.infer(model.variables, canvas)
    assert boxes.shape == (1, 4, 4) and masks.shape == (1, 4, 28, 28)
    assert labels.dtype == torch.int32 and torch.isfinite(scores).all()


def test_pytest_approx_rows_as_jax():
    a, b = [[1.0, 2.0], [3.0]], [[1.0, 2.0 + 1e-6], [3.0]]
    for rows in ((a, b), (a, [[1.0, 2.1], [3.0]]), (a, [[1.0, 2.0]]),
                 (a, [[1.0], [3.0]])):
        want = JD.pytest_approx_rows(*rows)
        got = PD.pytest_approx_rows(*rows)
        assert got is (rows[0] if want is rows[0] else rows[1])


def test_param_shardings_as_jax():
    """The placement of each parameter: per axis, the mesh axis it splits
    over, as the JAX package's PartitionSpecs on a (data, model) mesh."""
    want = JD.param_shardings(JD.make_mesh(4))
    mesh = Mesh(np.array([[torch.device("cpu")] * 2] * 2, dtype=object),
                ("data", "model"))
    got = PD.param_shardings(mesh)
    assert sorted(got) == sorted(want)
    for k, sharding in want.items():
        spec = tuple(sharding.spec) + (None,) * (
            len(got[k]) - len(tuple(sharding.spec)))
        assert got[k] == spec, k
    with pytest.raises(ValueError, match="'model' axis"):
        PD.param_shardings(Mesh([torch.device("cpu")] * 2, ("data",)))
