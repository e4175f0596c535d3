"""The port's image IO: JPEG and PNG files and the two resizes the data
path takes (in place of the reference's OpenCV calls).

Decoding and encoding run in `csrc/image_codec.h` (baseline JPEG after
libjpeg's ISLOW DCT, fancy upsampling and standard tables, so pixels
agree with OpenCV's; PNG over zlib), built with g++ at first use into
`build/davo_tpu_torch/` together with the snippet loader
(`csrc/snippet_loader.cc`, whose C entry points `native_loader.py` binds)
and loaded with ctypes. The build needs g++ and zlib's header, nothing
else; a failed build raises.

`resize_area` is OpenCV's INTER_AREA on uint8 images and
`resize_nearest` its INTER_NEAREST, in NumPy, step for step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
CSRC = _REPO / "davo_tpu_torch" / "csrc"
SOURCES = (CSRC / "snippet_loader.cc", CSRC / "image_codec.h")
BUILD_DIR = _REPO / "build" / "davo_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")
JPEG_QUALITY = 95  # OpenCV's imwrite default (and 4:2:0, as libjpeg's)

_lib = None
_lock = threading.Lock()


def _build() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    target = BUILD_DIR / f"libsnippet_loader-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCES[0]), *LIBS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"image codec build failed (g++ exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    """The codec and loader library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            ip = ctypes.POINTER(ctypes.c_int)
            u8 = ctypes.POINTER(ctypes.c_uint8)
            fp = ctypes.POINTER(ctypes.c_float)
            i32 = ctypes.POINTER(ctypes.c_int32)
            for name, res, args in (
                ("dv_last_error", None, [ctypes.c_char_p, ctypes.c_int]),
                ("dv_image_info", ctypes.c_int, [ctypes.c_char_p, ip, ip, ip]),
                ("dv_imread", ctypes.c_int,
                 [ctypes.c_char_p, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int]),
                ("dv_imwrite_jpeg", ctypes.c_int,
                 [ctypes.c_char_p, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
                ("dv_imwrite_png", ctypes.c_int,
                 [ctypes.c_char_p, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
                # The snippet loader (native_loader.py).
                ("snl_create", ctypes.c_void_p,
                 [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int]),
                ("snl_next", ctypes.c_int, [ctypes.c_void_p, fp, fp, fp, i32, fp]),
                ("snl_error", None, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
                ("snl_destroy", None, [ctypes.c_void_p]),
                ("snl_probe", ctypes.c_int, [ctypes.c_char_p, ip, ip]),
            ):
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
    return _lib


def _check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        buf = ctypes.create_string_buffer(1024)
        lib.dv_last_error(buf, len(buf))
        raise OSError(buf.value.decode(errors="replace"))


def image_info(path: str) -> tuple[int, int, int]:
    """(height, width, channels) from the file's header; channels 1 for
    gray files, 3 for colour."""
    lib = load_library()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.dv_image_info(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)))
    return h.value, w.value, c.value


def _imread(path: str, channels: int) -> np.ndarray:
    lib = load_library()
    h, w, _ = image_info(path)
    out = np.empty((h, w, channels), np.uint8)
    _check(lib, lib.dv_imread(os.fsencode(path), channels,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w))
    return out


def imread_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file as (H, W, 3) uint8 RGB (gray replicated, alpha
    dropped), as `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`.
    Raises OSError on a missing, unreadable or unsupported file."""
    return _imread(path, 3)


def imread_gray(path: str) -> np.ndarray:
    """A gray (label) image as (H, W) uint8; a colour file raises."""
    return _imread(path, 1)[..., 0]


def _writable(img: np.ndarray, channels: tuple[int, ...]) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"images are written from uint8, not {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or c not in channels:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    return img


def imwrite_jpg(path: str, rgb: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """(H, W, 3) uint8 RGB -> baseline JPEG, 4:2:0 (cv2.imwrite's
    defaults)."""
    img = _writable(rgb, (3,))
    lib = load_library()
    _check(lib, lib.dv_imwrite_jpeg(os.fsencode(path), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    img.shape[0], img.shape[1], int(quality)))


def imwrite_png(path: str, img: np.ndarray) -> None:
    """(H, W) gray or (H, W, 3) RGB uint8 -> 8-bit PNG."""
    img = _writable(img, (1, 3))
    c = 1 if img.ndim == 2 else img.shape[2]
    lib = load_library()
    _check(lib, lib.dv_imwrite_png(os.fsencode(path), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   img.shape[0], img.shape[1], c))


# ---------------------------------------------------------------------------
# Resizes
# ---------------------------------------------------------------------------


def _area_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's `computeResizeAreaTab`: per output index, the source
    indices and float32 weights in the order they are summed, padded
    with weight 0 (an exact no-op in the sums)."""
    scale = 1.0 / (n_out / n_in)
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(int(np.ceil(f1)), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        for s in range(s1, s2):
            row.append((s, 1.0 / cell))
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(t) for t in taps)
    idx = np.zeros((n_out, k), np.int64)
    wt = np.zeros((n_out, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j] = s
            wt[d, j] = np.float32(a)
    return idx, wt


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`
    for a uint8 (H, W) or (H, W, C) downscale: a copy at the same size;
    integer factors average their cells (2x2 as (sum + 2) >> 2, others
    as float32 sum / area rounded half to even); other factors sum each
    row's taps, then the rows', in float32 in OpenCV's order, and round
    half to even."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8, not {img.dtype}")
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    sx, sy = 1.0 / (width / W), 1.0 / (height / H)
    if sx < 1.0 or sy < 1.0:
        raise ValueError(f"resize_area only downscales ({H}x{W} -> {height}x{width})")
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
        cells = img[: height * iy, : width * ix].astype(np.int64)
        cells = cells.reshape(height, iy, width, ix, *img.shape[2:]).sum(axis=(1, 3))
        if ix == 2 and iy == 2 and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
            return ((cells + 2) >> 2).astype(np.uint8)
        scaled = cells.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
    xi, xw = _area_taps(W, width)
    yi, yw = _area_taps(H, height)
    src = img.astype(np.float32)
    extra = (None,) * (img.ndim - 2)
    rows = np.zeros((H, width) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        rows = rows + src[:, xi[:, j]] * xw[(None, slice(None), j) + extra]
    out = rows[yi[:, 0]] * yw[(slice(None), 0) + extra + (None,)]
    for j in range(1, yi.shape[1]):
        out = out + rows[yi[:, j]] * yw[(slice(None), j) + extra + (None,)]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)`:
    source index floor(i / (n_out / n_in)), clamped to the last."""
    H, W = img.shape[:2]
    yi = np.minimum(np.floor(np.arange(height) * (1.0 / (height / H))).astype(np.int64), H - 1)
    xi = np.minimum(np.floor(np.arange(width) * (1.0 / (width / W))).astype(np.int64), W - 1)
    return img[yi][:, xi]
