"""ICP correspondence+solve iterations per second.

Point-to-point ICP at eval scale (50k source x 50k target points, the
eval-script working set; workload contract:
eval/eval_table_chair/eval_table_chair.py:90-104) at a fixed iteration count,
with the radius-limited (windowed) and the full-scan correspondence search.
Each timing ends in a host fetch of the result, so it covers the device
work; the rate is iterations over the best of `reps` runs.

    python bench_icp.py            # the default NN implementation
    python bench_icp.py --ab       # Triton kernel vs plain search, in turns

Needs a GPU: without one it exits non-zero and prints no result.
"""

import json
import sys
import time

import numpy as np


def clouds(n: int, seed: int = 0):
    """(src, dst): a uniform cube and a slightly rotated, shifted copy."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    th = 0.02
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    dst = src @ R.T + np.array([0.01, -0.02, 0.005], np.float32)
    return src, dst


def measure(n: int = 50_000, impl: str = "auto", iters: int = 30,
            reps: int = 5, seed: int = 0) -> dict:
    """ICP iterations/s for the windowed and the full-scan search with NN
    implementation `impl` (see kernels.nn._resolve_impl), on the default
    device."""
    import jax.numpy as jnp

    from otslam_tpu.kernels.icp import icp_point_to_point
    from otslam_tpu.kernels.nn import auto_nn_window

    src, dst = clouds(n, seed)
    window, axis = auto_nn_window(src, dst, 0.3)
    src_d, dst_d = jnp.asarray(src), jnp.asarray(dst)

    def rate(**kw):
        def run():
            res = icp_point_to_point(
                src_d, dst_d, threshold=0.3, max_iterations=iters,
                relative_fitness=0.0, relative_rmse=0.0, nn_impl=impl, **kw)
            return int(res.iterations), float(res.inlier_rmse)

        t0 = time.perf_counter()
        run()                                     # compile + first run
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            it, rmse = run()
            times.append(time.perf_counter() - t0)
        return {"iters_per_s": it / min(times), "iterations": it,
                "final_rmse_m": rmse, "first_call_s": compile_s,
                "rep_s": times}

    return {"n": n, "impl": impl, "nn_window": window, "nn_axis": axis,
            "windowed": rate(nn_window=window, nn_axis=axis),
            "full_scan": rate()}


def _device_line() -> dict:
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench_icp: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": smi}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = _device_line()
    if "--ab" in argv:
        # kernel and plain search in turns: plain, triton, triton, plain
        for impl in ("plain", "triton", "triton", "plain"):
            print(json.dumps({**dev, **measure(impl=impl)}), flush=True)
    else:
        print(json.dumps({**dev, **measure()}), flush=True)


if __name__ == "__main__":
    main()
