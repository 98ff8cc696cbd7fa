"""``examples/pose_pipeline.py`` unedited under both packages (the harness
and tolerances of tests/test_torch_examples.py): on default weights with
``--faces --hands`` (the body's maps stay near 1e-4, so no person and no
crop in either package: counts 0 = 0 on 4 sampled frames), and on an npz
of the JAX package's body draw with the last stage's output layers
scaled by 1000 (PAF and heat peaks above the thresholds) through
``--weights``, where people's keypoints agree within 1e-4 (normalized)
and their counts are equal. The crop nets at 368 px on the CPU cost
about 0.2 TFLOP a crop; the npz run leaves them off."""

import jax
import numpy as np
import pytest

from test_torch_examples import (compare_runs, example_video,  # noqa: F401
                                 run_both)


def test_pose_example_default_weights(tmp_path, example_video):
    dbs = run_both(tmp_path, "pose_pipeline.py", example_video, "--faces",
                   "--hands")
    got = compare_runs(dbs, ["pose_out"])
    assert len(got["pose_out"]) == 4
    assert sum(len(r) for r in got["pose_out"]) == 0


@pytest.fixture(scope="module")
def body_npz(tmp_path_factory):
    from scannertools_tpu.models import pose
    from scannertools_tpu.models.weights import save_params

    tree = jax.tree_util.tree_map(np.array,
                                  pose.init_params(jax.random.PRNGKey(0)))
    for layer in ("s5_L1_6", "s5_L2_6"):  # Mconv7_stage6_L1 and _L2
        tree["params"][layer]["kernel"] *= 1000.0
    path = str(tmp_path_factory.mktemp("pose_npz") / "body.npz")
    save_params(path, tree)
    return path


def test_pose_example_on_an_npz(tmp_path, example_video, body_npz):
    dbs = run_both(tmp_path, "pose_pipeline.py", example_video,
                   "--weights", body_npz)
    got = compare_runs(dbs, ["pose_out"])
    assert sum(len(r) for r in got["pose_out"]) > 0
