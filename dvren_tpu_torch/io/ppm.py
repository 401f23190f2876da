"""Binary PPM (P6) images: the CLI's output format.

Counterpart of ``dvren_tpu/io/ppm.py`` (the reference CLI's writer,
``apps/dvren_render/main.cpp:281-299``): values clamped to [0, 1] and
rounded to bytes, so both packages write the same file for one image.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def write_ppm(path: str | os.PathLike, image) -> None:
    """Write ``image`` (H, W, 3) float, a numpy array or a tensor on any
    device, as a P6 PPM; values are clamped to [0, 1]."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("image must be (H, W, 3)")
    h, w, _ = image.shape
    data = np.clip(image, 0.0, 1.0)
    bytes_img = np.round(data * 255.0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(bytes_img.tobytes())


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Read a binary P6 PPM back to (H, W, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise ValueError("not a binary PPM (P6)")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        maxval = int(f.readline())
        raw = f.read(w * h * 3)
    arr = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    return arr.astype(np.float32) / float(maxval)
