"""What runs where: the compile-cache policy, the CLI's platform choices,
the dependency-free file formats of the main path, and the GPU-only paths
(which skip here; chip_smoke.py runs them on the card)."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from otslam_tpu import _compile_cache
from otslam_tpu.core import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

def test_cache_dir_is_fixed_inside_the_checkout():
    assert _compile_cache.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("platform,want", [
    (None, "repo"), ("", "repo"), ("gpu", "repo"), ("cuda", "repo"),
    ("cpu", None), ("CPU", None), ("cpu,gpu", None)])
def test_cache_policy_env_unset(monkeypatch, platform, want):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = _compile_cache.cache_dir_for(platform)
    assert got == (_compile_cache.CACHE_DIR if want == "repo" else None)


@pytest.mark.parametrize("platform", [None, "gpu", "cpu"])
def test_cache_policy_env_set_sets_nothing(monkeypatch, tmp_path, platform):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert _compile_cache.cache_dir_for(platform) is None
    _compile_cache.configure_compile_cache(platform)
    assert jax.config.jax_compilation_cache_dir == before


def test_configure_switches_between_repo_dir_and_off(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        _compile_cache.configure_compile_cache("gpu")
        assert jax.config.jax_compilation_cache_dir == \
            _compile_cache.CACHE_DIR
    finally:
        # the test process compiles on the CPU: keep it out of the checkout
        _compile_cache.configure_compile_cache("cpu")
    assert jax.config.jax_compilation_cache_dir is None


# ---------------------------------------------------------------------------
# CLI platform and backend choices
# ---------------------------------------------------------------------------

def test_cli_platform_gpu_parses():
    from otslam_tpu.cli import build_parser

    parser = build_parser()
    args = parser.parse_args(["--platform", "gpu", "reconstruct",
                              "--dataset", "d"])
    assert args.platform == "gpu" and args.backend == "sparse"
    platform = next(a for a in parser._actions if a.dest == "platform")
    assert list(platform.choices) == ["cpu", "gpu"]


@pytest.mark.parametrize("argv", [
    ["--platform", "metal", "bench"],
    ["reconstruct", "--dataset", "d", "--backend", "pallas"]])
def test_cli_rejects_removed_choices(argv, capsys):
    from otslam_tpu.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


# ---------------------------------------------------------------------------
# PNG codec and map YAML without optional packages
# ---------------------------------------------------------------------------

def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """A PNG whose rows use the given filter types (0-4), built by a
    straightforward per-byte encoder independent of core.io."""
    h = img.shape[0]
    ctype, depth = (2, 8) if img.ndim == 3 else (0, 16)
    rows = (img if img.dtype == np.uint8 else img.astype(">u2"))
    rows = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    bpp = 3 if img.ndim == 3 else 2
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        cur = rows[r].astype(np.int64)
        ft = filters[r % len(filters)]
        enc = []
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc.append((cur[i] - pred) % 256)
        out += bytes([ft]) + bytes(enc)
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    w = img.shape[1]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_roundtrip(tmp_path, rng, kind):
    if kind == "rgb8":
        img = rng.integers(0, 256, (23, 17, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (23, 17), dtype=np.uint16)
    path = str(tmp_path / "x.png")
    tio.write_png(path, img)
    got = tio.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_decodes_every_filter_type(rng, kind):
    if kind == "rgb8":
        img = rng.integers(0, 256, (10, 9, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (10, 9), dtype=np.uint16)
    data = _png_with_filters(img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(tio.decode_png(data), img)


def test_png_rejects_unsupported():
    with pytest.raises(ValueError):
        tio.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        tio.decode_png(b"GIF89a....")


def test_map_yaml_roundtrip_without_pyyaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = str(tmp_path / "map.yaml")
    tio.write_map_yaml(path, "map.pgm", 0.05, (-10.25, 3.5, 0.0))
    meta = tio.read_map_yaml(path)
    assert meta == {"image": "map.pgm", "resolution": 0.05,
                    "origin": [-10.25, 3.5, 0.0], "negate": 0,
                    "occupied_thresh": 0.65, "free_thresh": 0.196}


def test_map_yaml_reads_slam_toolbox_style(tmp_path):
    path = tmp_path / "map.yaml"
    path.write_text("image: 'room.pgm'  # saved map\nmode: trinary\n"
                    "resolution: 0.05\norigin: [-5.2, -5.2, 0]\n"
                    "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.25\n")
    meta = tio.read_map_yaml(str(path))
    assert meta["image"] == "room.pgm" and meta["mode"] == "trinary"
    assert meta["origin"] == [-5.2, -5.2, 0]


def test_dataset_roundtrip_without_image_packages(tmp_path, monkeypatch,
                                                  rng):
    """Simulated captures write and read back with no cv2/PIL: colour as
    lossless PNG, depth as 16-bit PNG."""
    from otslam_tpu.config import CameraConfig
    from otslam_tpu.pipeline.dataset import CaptureDataset

    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    cam = CameraConfig(width=16, height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    ds = CaptureDataset(str(tmp_path), cam)
    color = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 2.5, (12, 16)).astype(np.float32)
    for _ in range(2):
        ds.save_frame("Object_0", color, depth, np.eye(4))
    assert sorted(os.listdir(tmp_path / "color")) == ["Object_0_1.png",
                                                     "Object_0_2.png"]
    batch = ds.load_object("Object_0")
    np.testing.assert_array_equal(batch.colors[0], color.astype(np.float32))
    np.testing.assert_allclose(batch.depths[0], np.round(depth * 1000) / 1000,
                               atol=1e-6)
    # a JPEG frame without an image package is an error, not a skip
    (tmp_path / "color" / "Object_1_1.jpg").write_bytes(b"\xff\xd8")
    tio.write_depth_png(str(tmp_path / "depth" / "Object_1_1.png"), depth)
    tio.write_pose_txt(str(tmp_path / "poses" / "Object_1_1.txt"), np.eye(4))
    with pytest.raises(ImportError, match="JPEG"):
        ds.load_object("Object_1")


def test_main_path_imports_without_optional_packages():
    """The CLI and the mission -> capture -> reconstruct -> eval modules
    import with yaml, cv2 and PIL unavailable."""
    code = ("import sys; sys.modules.update(dict.fromkeys("
            "['yaml', 'cv2', 'PIL'])); import otslam_tpu.cli, "
            "otslam_tpu.sim.runner, otslam_tpu.pipeline.reconstruct, "
            "otslam_tpu.eval.headline, otslam_tpu.mapping.hybrid")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# GPU-only
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    """The first GPU device; skips where JAX has none (the test suite runs
    on the CPU — chip_smoke.py covers these paths on the card)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return dev


@pytest.mark.gpu
def test_triton_nn_kernel_matches_plain(gpu, rng):
    import jax.numpy as jnp

    from otslam_tpu.kernels.nn import nn_distance

    src = jnp.asarray(rng.uniform(-2, 2, (3000, 3)).astype(np.float32))
    dst = jnp.asarray(rng.uniform(-2, 2, (5000, 3)).astype(np.float32))
    d1, i1 = nn_distance(src, dst, with_index=True, impl="triton")
    d2, i2 = nn_distance(src, dst, with_index=True, impl="plain")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)
