"""Output artifact writers -- parity with the reference's savers.

Port of dvs_mcemvs_tpu/io/outputs.py with the same artifacts and file names.
It needs no OpenCV: PNGs are written by an 8-bit grey/BGR PNG encoder on
zlib, the colour map is OpenCV's JET as a table (`JET_BGR`), and the 3 x 3
elliptical dilation is a maximum over its cross.  `cv2.imread` reads the
files back pixel for pixel as the JAX package writes them.

Covers `saveDepthMaps` (reference: mapper_emvs_stereo/src/utils.cpp:22-120:
depth-points txt, negated-confidence PNG, dilated JET inverse-depth PNG),
`accumulateEvents` previews (utils.cpp:184-216), DSI `.npy` dumps
(cartesian3dgrid/src/cartesian3dgrid_IO.cpp:30-36), per-slice PNG dumps
(:39-76), and the conf-range stats file (mapper_emvs_stereo.cpp:378-388).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..mapper import Events

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET): the
# BGR colour of each 8-bit value (OpenCV 4/5).
JET_BGR = np.frombuffer(bytes.fromhex(
    '8000008400008800008c00009000009400009800009c0000a00000a40000a800'
    '00ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d4'
    '0000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000'
    'ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff28'
    '00ff2c00ff3000ff3400ff3800ff3c00ff4000ff4400ff4800ff4c00ff5000ff'
    '5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00'
    'ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa8'
    '00ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00ffd000ff'
    'd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00'
    'feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff'
    '2ad2ff2eceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aa'
    'ff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e'
    '7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ff'
    'aa52ffae4effb24affb646ffba42ffbe3effc23affc636ffca32ffce2effd22a'
    'ffd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe'
    '00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4'
    'ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff00acff00'
    'a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff'
    '007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054'
    'ff0050ff004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff00'
    '28ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff'
    '0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000'
    'd40000d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac00'
    '00a80000a40000a000009c00009800009400009000008c000088000084000080'
), np.uint8).reshape(256, 3)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit (H, W) grey or (H, W, 3) BGR image as PNG bytes (stored as
    RGB, as cv2.imwrite stores BGR arrays)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG images here are uint8, got {img.dtype}")
    if img.ndim == 2:
        color, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color, rows = 2, img[..., ::-1].reshape(img.shape[0], -1)
    else:
        raise ValueError(f"PNG images here are (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _imwrite(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def dilate_cross(img: np.ndarray) -> np.ndarray:
    """cv2.dilate with the 3 x 3 elliptical element, which is the cross:
    the maximum over each pixel and its four neighbours, per channel,
    ignoring what lies outside the image."""
    p = np.pad(img, [(1, 1), (1, 1)] + [(0, 0)] * (img.ndim - 2))
    return np.maximum.reduce([p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1],
                              p[1:-1, :-2], p[1:-1, 2:]])


def timestamp_prefix(out_dir: str, ts: float) -> str:
    """The reference's '%013.9f'-style time-prefixed basename
    (process1.cpp:121-122)."""
    return os.path.join(out_dir, f"{ts:013.9f}")


def save_depth_points_txt(path: str, depth: np.ndarray, mask: np.ndarray) -> None:
    """`[col row depth]` per masked pixel (utils.cpp:31-46).

    Formats native Python scalars (`.tolist()`) in one %-join: formatting
    numpy scalars line-by-line cost ~130 ms per DSEC-sized chunk — the
    dominant cost of the full_seq save pipeline (the one-chunk-deep overlap
    hides device compute, not host serialization); this path is ~4x
    faster."""
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    d = np.asarray(depth)[ys, xs]
    s = "".join(["%d %d %.7g\n" % tup
                 for tup in zip(xs.tolist(), ys.tolist(), d.tolist())])
    with open(path, "w") as f:
        f.write(s)


def save_confidence_negated_png(path: str, confidence: np.ndarray) -> None:
    """255 - minmax-normalized confidence (utils.cpp:54-58)."""
    c = np.asarray(confidence, np.float64)
    rng = c.max() - c.min()
    norm = (c - c.min()) * (255.0 / rng) if rng > 0 else np.zeros_like(c)
    _imwrite(path, (255.0 - norm).astype(np.uint8))


def save_inv_depth_colored_png(
    path: str, depth: np.ndarray, mask: np.ndarray,
    min_depth: float, max_depth: float,
) -> None:
    """JET-colored inverse depth on black, masked, dilated by a 3x3 ellipse
    (utils.cpp:81-93; the ESVO-style visualization)."""
    depth = np.asarray(depth, np.float64)
    with np.errstate(divide="ignore"):
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-12), 0.0)
    scale = 255.0 / (1.0 / min_depth - 1.0 / max_depth)
    inv255 = (inv - 1.0 / max_depth) * scale
    inv8 = np.clip(inv255, 0, 255).astype(np.uint8)
    color = JET_BGR[inv8]
    canvas = np.zeros_like(color)
    m = np.asarray(mask) > 0
    canvas[m] = color[m]
    _imwrite(path, dilate_cross(canvas))


def save_depth_maps(
    depth: np.ndarray,
    confidence: np.ndarray,
    mask: np.ndarray,
    min_depth: float,
    max_depth: float,
    suffix: str,
    out_prefix: str,
) -> None:
    """The full saveDepthMaps artifact set (utils.cpp:22-120)."""
    save_depth_points_txt(f"{out_prefix}depth_points_{suffix}.txt", depth, mask)
    save_confidence_negated_png(
        f"{out_prefix}confidence_map_negated_{suffix}.png", confidence)
    save_inv_depth_colored_png(
        f"{out_prefix}inv_depth_colored_dilated_{suffix}.png",
        depth, mask, min_depth, max_depth)


def accumulate_events_image(
    ev: Events, width: int, height: int, use_polarity: bool = True
) -> np.ndarray:
    """Event-count / polarity-balance preview image (utils.cpp:184-216)."""
    img = np.zeros((height, width), np.float64)
    if ev.num:
        pol = np.ones(ev.num) if ev.p is None else np.where(np.asarray(ev.p) > 0, 1.0, -1.0)
        if not use_polarity:
            pol = np.ones(ev.num)
        np.add.at(img, (np.asarray(ev.y), np.asarray(ev.x)), pol)
    if use_polarity:
        half = max(abs(img.min()), abs(img.max()))
        if half > 0:
            img = img * (128.0 / half) + 128.0
        else:
            img = np.full_like(img, 128.0)
        return np.clip(img, 0, 255).astype(np.uint8)
    rng = img.max() - img.min()
    if rng > 0:
        img = (img - img.min()) * (255.0 / rng)
    return img.astype(np.uint8)


def save_events_png(path: str, ev: Events, width: int, height: int) -> None:
    _imwrite(path, accumulate_events_image(ev, width, height))


def write_dsi_npy(path: str, dsi: np.ndarray) -> None:
    """DSI dump with the reference's (Z, Y, X) layout
    (cartesian3dgrid_IO.cpp:30-36) — our native layout already."""
    np.save(path, np.asarray(dsi, np.float32))


def write_dsi_slices_png(out_dir: str, dsi: np.ndarray, prefix: str = "slice") -> None:
    """Per-z-slice normalized PNGs (cartesian3dgrid_IO.cpp:39-76)."""
    os.makedirs(out_dir, exist_ok=True)
    d = np.asarray(dsi)
    lo, hi = d.min(), d.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    for z in range(d.shape[0]):
        img = ((d[z] - lo) * scale).astype(np.uint8)
        _imwrite(os.path.join(out_dir, f"{prefix}_{z:04d}.png"), img)


def save_conf_stats(path: str, cmin: float, cmax: float, append: bool = True) -> None:
    """Per-chunk nonzero confidence range (mapper_emvs_stereo.cpp:378-388)."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        f.write(f"{cmin} {cmax}\n")


def save_dense_depth_png(path: str, depth_dense: np.ndarray,
                         min_depth: float, max_depth: float) -> None:
    """Normalized 8-bit PNG of the Telea-inpainted dense depth map.

    The reference computes this map on every extraction
    (mapper_emvs_stereo.cpp:429-436) but its save path is commented out
    (utils.cpp:96-104); here the artifact is actually written.
    """
    d = np.asarray(depth_dense, np.float32)
    span = max(max_depth - min_depth, 1e-9)
    img = np.clip((d - min_depth) * (255.0 / span), 0, 255).astype(np.uint8)
    _imwrite(path, img)
