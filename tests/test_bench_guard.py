"""bench.py / bench_icp.py: the measurement functions run at tiny sizes on
the CPU, and the entry points refuse to report without a GPU."""

import importlib.util
import os
import sys

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "bench.py")
spec = importlib.util.spec_from_file_location("bench_mod", _BENCH)
bench = importlib.util.module_from_spec(spec)
sys.modules.setdefault("bench_mod", bench)
spec.loader.exec_module(bench)


def test_bench_icp_cpu_path_smoke():
    """bench_icp.measure() at a tiny size returns finite, positive rates
    for both searches and runs exactly the requested iterations."""
    import bench_icp

    out = bench_icp.measure(n=2000, impl="plain", iters=4, reps=1)
    for key in ("windowed", "full_scan"):
        r = out[key]
        assert 0 < r["iters_per_s"] < float("inf")
        assert r["iterations"] == 4
        assert r["final_rmse_m"] < 0.05
    assert 0 < out["nn_window"]


@pytest.mark.parametrize("entry", ["bench", "bench_icp"])
def test_entry_points_refuse_cpu(entry):
    import bench_icp

    fn = bench.device_record if entry == "bench" else bench_icp._device_line
    with pytest.raises(SystemExit, match="GPU"):
        fn()


def test_frame_poses_face_the_target():
    """Every capture-circle camera looks at the origin from 1.2 m."""
    import numpy as np

    Rs, eyes, exts = bench._frame_poses(12)
    for R, eye, E in zip(Rs, eyes, exts):
        assert abs(np.linalg.norm(eye[:2]) - 1.2) < 1e-5
        fwd = R[:, 2]
        np.testing.assert_allclose(fwd, -eye / np.linalg.norm(eye),
                                   atol=1e-5)
        # the extrinsic maps the eye to the camera origin
        np.testing.assert_allclose(E[:3, :3] @ eye + E[:3, 3], 0, atol=1e-5)
