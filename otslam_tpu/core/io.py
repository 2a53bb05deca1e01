"""File IO for the OTSLAM on-disk formats.

The reference's process boundaries are all files (SURVEY.md §5 checkpoint):
  * capture dataset: color/<label>_<n>.{png,jpg}, depth/<label>_<n>.png
    (uint16 mm), poses/<label>_<n>.txt (4x4 map->camera matrix)
    [scanner_node.cpp:268-299]
  * 2D maps: PGM + YAML (slam_toolbox format)        [hybrid_map.py:31-38]
  * 3D objects / hybrid maps: .ply point clouds      [reconstruct_rgbd_filter.py:140]

This module implements all of them with numpy and the standard library (no
Open3D): PLY in both binary and ascii, with point clouds
(xyz[+rgb][+normals]) and triangle meshes; PNG (8-bit RGB and 16-bit grey)
through zlib; the flat map YAML. Only JPEG (the reference robot's colour
frames) needs OpenCV or Pillow.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              faces: Optional[np.ndarray] = None, binary: bool = True) -> None:
    """Write a point cloud or triangle mesh to PLY.

    colors: float [0,1] or uint8; stored as uchar r,g,b.
    faces: (M,3) int vertex indices -> triangle mesh.
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              "comment produced by otslam_tpu",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = None
    if colors is not None:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(np.asarray(cols, dtype=np.float64) * 255.0, 0, 255).astype(np.uint8)
        cols = cols.reshape(-1, 3)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    nrm = None
    if normals is not None:
        nrm = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        header += ["property float nx", "property float ny", "property float nz"]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if cols is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            if nrm is not None:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            rec = np.zeros(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = points.T
            if cols is not None:
                rec["red"], rec["green"], rec["blue"] = cols.T
            if nrm is not None:
                rec["nx"], rec["ny"], rec["nz"] = nrm.T
            f.write(rec.tobytes())
            if faces is not None:
                frec = np.zeros(faces.shape[0],
                                dtype=np.dtype([("k", "u1"), ("a", "<i4"),
                                                ("b", "<i4"), ("c", "<i4")]))
                frec["k"] = 3
                frec["a"], frec["b"], frec["c"] = faces.T
                f.write(frec.tobytes())
        else:
            rows = []
            for i in range(n):
                row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
                if cols is not None:
                    row += f" {cols[i,0]} {cols[i,1]} {cols[i,2]}"
                if nrm is not None:
                    row += f" {nrm[i,0]:.6f} {nrm[i,1]:.6f} {nrm[i,2]:.6f}"
                rows.append(row)
            if faces is not None:
                rows += [f"3 {a} {b} {c}" for a, b, c in faces]
            f.write(("\n".join(rows) + "\n").encode("ascii"))


def read_ply(path: str) -> dict:
    """Read a PLY file. Returns dict with 'points' (n,3) f32 and optionally
    'colors' (n,3) f32 in [0,1], 'normals' (n,3) f32, 'faces' (m,3) i32."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []  # (name, count, [(prop, type)|('list',...)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))

    out: dict = {}
    offset = 0
    if fmt.startswith("binary"):
        little = "little" in fmt
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # assume uniform triangle lists (as written by Open3D/us)
                cnt_t = _PLY_DTYPES[props[0][1]]
                idx_t = _PLY_DTYPES[props[0][2]]
                if not little:
                    cnt_t, idx_t = cnt_t.replace("<", ">"), idx_t.replace("<", ">")
                k = int(np.frombuffer(body, dtype=cnt_t, count=1, offset=offset)[0])
                rec = np.dtype([("k", cnt_t), ("v", idx_t, (k,))])
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                if name == "face":
                    out["faces"] = arr["v"].astype(np.int32)
            else:
                fields = [(p[0], _PLY_DTYPES[p[1]] if little
                           else _PLY_DTYPES[p[1]].replace("<", ">")) for p in props]
                rec = np.dtype(fields)
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                if name == "vertex":
                    _extract_vertex(out, arr)
    else:
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                faces = []
                for _ in range(count):
                    k = int(text[pos]); pos += 1
                    faces.append([int(text[pos + i]) for i in range(k)])
                    pos += k
                if name == "face":
                    out["faces"] = np.asarray(faces, dtype=np.int32)
            else:
                ncol = len(props)
                vals = np.asarray(text[pos:pos + count * ncol], dtype=np.float64)
                pos += count * ncol
                arr2 = vals.reshape(count, ncol)
                names = [p[0] for p in props]
                rec = {nm: arr2[:, i] for i, nm in enumerate(names)}
                if name == "vertex":
                    _extract_vertex_dict(out, rec, names)
    return out


def _extract_vertex(out: dict, arr: np.ndarray) -> None:
    names = arr.dtype.names
    out["points"] = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        cols = np.stack([arr["red"], arr["green"], arr["blue"]], axis=-1)
        out["colors"] = (cols.astype(np.float32) / 255.0
                         if cols.dtype == np.uint8 else cols.astype(np.float32))
    if all(c in names for c in ("nx", "ny", "nz")):
        out["normals"] = np.stack([arr["nx"], arr["ny"], arr["nz"]], axis=-1).astype(np.float32)


def _extract_vertex_dict(out: dict, rec: dict, names: list) -> None:
    out["points"] = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        out["colors"] = (np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
                         / 255.0).astype(np.float32)
    if all(c in names for c in ("nx", "ny", "nz")):
        out["normals"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# PGM + map YAML (slam_toolbox conventions)
# ---------------------------------------------------------------------------

def read_pgm(path: str) -> np.ndarray:
    """Read a (P2 ascii or P5 binary) PGM image as uint8 (row 0 = top)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[i:])
        if m is None:
            raise ValueError(f"{path}: malformed PGM header")
        tok = m.group(1)
        i += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        # exactly one whitespace byte separates maxval from the binary raster
        img = np.frombuffer(data, dtype=np.uint8, count=w * h, offset=i + 1)
        return img.reshape(h, w).copy()
    elif magic == b"P2":
        vals = np.asarray(data[i:].split()[: w * h], dtype=np.uint8)
        return vals.reshape(h, w)
    raise ValueError(f"{path}: unsupported PGM magic {magic!r}")


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode("ascii"))
        f.write(img.tobytes())


def _yaml_scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    return t


def read_map_yaml(path: str) -> dict:
    """Read a slam_toolbox / map_server map YAML: flat ``key: value`` lines,
    values scalars or ``[a, b, c]`` flow lists; ``#`` starts a comment."""
    out = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, sep, val = line.partition(":")
            if not sep:
                raise ValueError(f"{path}: not a flat map YAML line: {line!r}")
            val = val.strip()
            if val.startswith("[") and val.endswith("]"):
                out[key.strip()] = [_yaml_scalar(v)
                                    for v in val[1:-1].split(",") if v.strip()]
            else:
                out[key.strip()] = _yaml_scalar(val)
    return out


def write_map_yaml(path: str, image: str, resolution: float,
                   origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                   negate: int = 0, occupied_thresh: float = 0.65,
                   free_thresh: float = 0.196) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    org = ", ".join(repr(float(o)) for o in origin)
    with open(path, "w") as f:
        f.write(f"image: {image}\n"
                f"resolution: {float(resolution)!r}\n"
                f"origin: [{org}]\n"
                f"negate: {int(negate)}\n"
                f"occupied_thresh: {float(occupied_thresh)!r}\n"
                f"free_thresh: {float(free_thresh)!r}\n")


# ---------------------------------------------------------------------------
# PNG (8-bit RGB colour, 16-bit grey depth)
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (grey, RGB, grey+alpha, RGBA; palettes unsupported)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) uint16 grey -> PNG bytes (filter 0)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, raw = 8, 2, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, raw = 16, 0, img.astype(">u2")
    else:
        raise ValueError(f"PNG encoder takes (H,W,3) uint8 or (H,W) uint16, "
                         f"got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(raw).reshape(h, -1).view(np.uint8)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _unfilter_slow(ftype: int, line, prev, bpp: int):
    """Average (3) and Paeth (4) rows depend on the decoded left neighbour
    byte by byte; they only occur in files from other encoders."""
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16 (8/16-bit,
    non-interlaced, non-palette: every file encode_png writes, and the
    depth/colour PNGs other encoders write)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = raw[r, 0], raw[r, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _unfilter_slow(int(ftype), line, prev, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prev = out[r]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# Capture dataset (scanner_node format)
# ---------------------------------------------------------------------------

def read_pose_txt(path: str) -> np.ndarray:
    """4x4 map->camera pose matrix, 6-decimal text (scanner_node.cpp:290-297)."""
    return np.loadtxt(path).reshape(4, 4)


def write_pose_txt(path: str, pose: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.asarray(pose).reshape(4, 4), fmt="%.6f")


def read_depth_png(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """uint16 mm depth PNG -> float32 meters (0 where invalid)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return read_png(path).astype(np.float32) / depth_scale


def write_depth_png(path: str, depth_m: np.ndarray, depth_scale: float = 1000.0,
                    depth_max: float = 5.0) -> None:
    """float meters -> uint16 mm PNG with the scanner_node clipping semantics:
    NaN -> 0, > depth_max -> 0 (scanner_node.cpp:277-281)."""
    d = np.asarray(depth_m, dtype=np.float32).copy()
    d[~np.isfinite(d)] = 0.0
    d[d > depth_max] = 0.0
    u16 = np.round(d * depth_scale).astype(np.uint16)  # cv::convertTo rounds
    write_png(path, u16)


def _image_module():
    """OpenCV or Pillow, for JPEG (the reference robot's colour frames)."""
    try:
        import cv2
        return cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return Image
    except ImportError:
        raise ImportError("JPEG colour frames need OpenCV (cv2) or Pillow; "
                          "PNG needs neither") from None


def read_color(path: str) -> np.ndarray:
    """Color image (PNG, or JPEG through cv2/Pillow) -> (H, W, 3) uint8 RGB."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] < 3:
            raise ValueError(f"{path}: not an 8-bit colour PNG")
        return np.ascontiguousarray(img[..., :3])
    mod = _image_module()
    if getattr(mod, "__name__", "") == "cv2":
        bgr = mod.imread(path, mod.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"{path}: unreadable image")
        return bgr[..., ::-1].copy()
    return np.asarray(mod.open(path).convert("RGB"))


def write_color(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) RGB, uint8 or float in [0, 1] -> PNG, or JPEG through
    cv2/Pillow by extension."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, rgb)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mod = _image_module()
    if getattr(mod, "__name__", "") == "cv2":
        mod.imwrite(path, rgb[..., ::-1])
    else:
        mod.fromarray(rgb).save(path)
