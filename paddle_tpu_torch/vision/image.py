"""Image IO backend selection (the port's copy of
``paddle_tpu/vision/image.py``; PIL and OpenCV are imported at use).

ref: python/paddle/vision/image.py (set_image_backend /
get_image_backend / image_load): datasets return either PIL images
('pil', default) or numpy/cv2 arrays ('cv2')."""
from __future__ import annotations

import numpy as np

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKEND = "pil"


def set_image_backend(backend: str):
    """Pick the decode backend used by image_load and the vision
    datasets. 'cv2' is honored when OpenCV is installed; otherwise the
    cv2 setting still returns numpy HWC-BGR arrays decoded via PIL (the
    array contract, without the native dependency)."""
    global _BACKEND
    if backend not in ("pil", "cv2"):
        raise ValueError(
            f"image backend must be 'pil' or 'cv2', got {backend!r}")
    _BACKEND = backend


def get_image_backend() -> str:
    return _BACKEND


def image_load(path: str, backend: str | None = None):
    """Load an image file. 'pil' -> PIL.Image; 'cv2' -> numpy uint8
    HWC in BGR channel order (cv2's convention)."""
    b = backend or _BACKEND
    if b not in ("pil", "cv2"):
        raise ValueError(
            f"image backend must be 'pil' or 'cv2', got {b!r}")
    if b == "cv2":
        try:
            import cv2
            return cv2.imread(path)
        except ImportError:
            from PIL import Image
            arr = np.asarray(Image.open(path).convert("RGB"))
            return arr[:, :, ::-1].copy()  # RGB -> BGR, cv2 contract
    from PIL import Image
    return Image.open(path)
