"""Image transforms (host-side, numpy).

The port's copy of ``paddle_tpu/vision/transforms.py`` (numpy only; ref:
python/paddle/vision/transforms/transforms.py). These run in the input
pipeline on the host (a DataLoader's workers); the random ones draw
from Python's ``random`` module, as in the JAX package.
"""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
]


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))


class ToTensor(BaseTransform):
    """HWC uint8 -> CHW float32 in [0,1] (ref: transforms.py ToTensor)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[:, :, None]
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = img.astype(np.float32)
        if self.data_format == "CHW":
            return (img - self.mean[:, None, None]) / self.std[:, None, None]
        return (img - self.mean) / self.std


def _resize_np(img, size):
    """Nearest-neighbor resize without external deps."""
    if isinstance(size, int):
        h, w = img.shape[:2]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    oh, ow = size
    h, w = img.shape[:2]
    ys = (np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs]


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def _apply_image(self, img):
        return _resize_np(img, self.size)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        if self.padding:
            pad = [(self.padding, self.padding), (self.padding, self.padding)]
            if img.ndim == 3:
                pad.append((0, 0))
            img = np.pad(img, pad)
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return img[::-1].copy()
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        pad = [(p[1], p[3]), (p[0], p[2])]
        if img.ndim == 3:
            pad.append((0, 0))
        return np.pad(img, pad, constant_values=self.fill)


# ---------------------------------------------------------------------------
# functional API (ref: python/paddle/vision/transforms/functional.py) —
# host-side numpy; images are HWC (or HW) arrays like the class
# transforms above
# ---------------------------------------------------------------------------

def to_tensor(pic, data_format="CHW"):
    """HWC uint8/float image -> normalized float32 tensor array
    (ref: functional.py to_tensor)."""
    return ToTensor(data_format)(pic)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


def _bilinear_sample(img, ys, xs, fill=0.0):
    """Sample img (HWC) at fractional (ys, xs) grids with bilinear
    interpolation; out-of-bounds reads produce ``fill``."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1, x1 = y0 + 1, x0 + 1
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0)
             & (xs <= w - 1))[..., None]
    imgf = img.astype(np.float32)

    def at(yy, xx):
        yc = np.clip(yy, 0, h - 1)
        xc = np.clip(xx, 0, w - 1)
        return imgf[yc, xc]

    out = ((1 - wy) * (1 - wx) * at(y0, x0)
           + (1 - wy) * wx * at(y0, x1)
           + wy * (1 - wx) * at(y1, x0)
           + wy * wx * at(y1, x1))
    out = np.where(valid, out, np.float32(fill))
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    else:
        out = out.astype(img.dtype)
    return out[:, :, 0] if squeeze else out


def resize(img, size, interpolation="bilinear"):
    """ref: functional.py resize; bilinear (default) or nearest."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    oh, ow = size
    if interpolation == "nearest":
        return _resize_np(img, (oh, ow))
    ys = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return _bilinear_sample(img, np.clip(gy, 0, h - 1),
                            np.clip(gx, 0, w - 1))


def pad(img, padding, fill=0, padding_mode="constant"):
    """ref: functional.py pad; padding int or (l, t, r, b)."""
    img = np.asarray(img)
    p = padding
    if isinstance(p, int):
        p = (p, p, p, p)
    elif len(p) == 2:
        p = (p[0], p[1], p[0], p[1])
    cfg = [(p[1], p[3]), (p[0], p[2])] + \
        ([(0, 0)] if img.ndim == 3 else [])
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    if mode == "constant":
        return np.pad(img, cfg, mode, constant_values=fill)
    return np.pad(img, cfg, mode)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    img = np.asarray(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    th, tw = output_size
    h, w = img.shape[:2]
    return crop(img, max((h - th) // 2, 0), max((w - tw) // 2, 0), th, tw)


def _inverse_affine_grid(h, w, matrix):
    """Output-pixel grid mapped through the INVERSE 2x3 affine matrix
    (center-origin convention, like the reference's cv2/PIL path)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    xr, yr = xx - cx, yy - cy
    a, b, tx, c, d, ty = matrix
    xs = a * xr + b * yr + tx + cx
    ys = c * xr + d * yr + ty + cy
    return ys, xs


def _affine_inverse(angle, translate, scale, shear):
    """Inverse of the affine transform built from rotate/translate/
    scale/shear (degrees), as a flat 2x3 (a, b, tx, c, d, ty)."""
    import math as _m
    rot = _m.radians(angle)
    sx, sy = (_m.radians(s) for s in shear)
    # forward: M = R(rot) * Shear(sx, sy) * scale, then + translate
    a = _m.cos(rot - sy) / _m.cos(sy)
    b = -(_m.cos(rot - sy) * _m.tan(sx) / _m.cos(sy) + _m.sin(rot))
    c = _m.sin(rot - sy) / _m.cos(sy)
    d = -(_m.sin(rot - sy) * _m.tan(sx) / _m.cos(sy) - _m.cos(rot))
    fwd = np.array([[scale * a, scale * b, translate[0]],
                    [scale * c, scale * d, translate[1]],
                    [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(fwd)
    return (inv[0, 0], inv[0, 1], inv[0, 2],
            inv[1, 0], inv[1, 1], inv[1, 2])


def affine(img, angle, translate, scale, shear, interpolation="bilinear",
           fill=0, center=None):
    """ref: functional.py affine — rotate/translate/scale/shear about
    the image center, inverse-mapped with bilinear sampling."""
    img = np.asarray(img)
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    h, w = img.shape[:2]
    m = _affine_inverse(angle, translate, scale, tuple(shear))
    ys, xs = _inverse_affine_grid(h, w, m)
    return _bilinear_sample(img, ys, xs, fill=fill)


def rotate(img, angle, interpolation="bilinear", expand=False, center=None,
           fill=0):
    """ref: functional.py rotate (expand=False keeps the input size)."""
    return affine(img, angle, (0.0, 0.0), 1.0, (0.0, 0.0),
                  interpolation, fill, center)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """ref: functional.py perspective — warp mapping ``startpoints`` to
    ``endpoints`` (4 corner points each, (x, y))."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    # solve the 8-dof homography sending endpoints -> startpoints
    # (inverse mapping: output pixel -> input location)
    A, bvec = [], []
    for (xe, ye), (xs_, ys_) in zip(endpoints, startpoints):
        A.append([xe, ye, 1, 0, 0, 0, -xs_ * xe, -xs_ * ye])
        A.append([0, 0, 0, xe, ye, 1, -ys_ * xe, -ys_ * ye])
        bvec.extend([xs_, ys_])
    coef = np.linalg.solve(np.asarray(A, np.float64),
                           np.asarray(bvec, np.float64))
    a, b, c, d, e, f, g, hh = coef
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    den = g * xx + hh * yy + 1.0
    xs = (a * xx + b * yy + c) / den
    ys = (d * xx + e * yy + f) / den
    return _bilinear_sample(img, ys, xs, fill=fill)


def to_grayscale(img, num_output_channels=1):
    """ITU-R 601-2 luma (ref: functional.py to_grayscale)."""
    img = np.asarray(img)
    lum = (0.299 * img[..., 0] + 0.587 * img[..., 1]
           + 0.114 * img[..., 2])
    if np.issubdtype(img.dtype, np.integer):
        lum = np.clip(np.round(lum), 0, 255).astype(img.dtype)
    else:
        lum = lum.astype(img.dtype)
    return np.stack([lum] * num_output_channels, axis=-1)


def _blend(img, other, factor):
    out = (img.astype(np.float32) * factor
           + other.astype(np.float32) * (1.0 - factor))
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(np.asarray(img).dtype)
    return out.astype(np.asarray(img).dtype)


def adjust_brightness(img, brightness_factor):
    """ref: functional.py adjust_brightness: blend with black."""
    img = np.asarray(img)
    return _blend(img, np.zeros_like(img), brightness_factor)


def adjust_contrast(img, contrast_factor):
    """ref: functional.py adjust_contrast: blend with the mean gray."""
    img = np.asarray(img)
    gray = to_grayscale(img)[..., 0].astype(np.float32)
    mean = np.full_like(img, gray.mean(), dtype=np.float32)
    return _blend(img, mean, contrast_factor)


def adjust_saturation(img, saturation_factor):
    """ref: functional.py adjust_saturation: blend with grayscale."""
    img = np.asarray(img)
    gray = np.broadcast_to(to_grayscale(img), img.shape)
    return _blend(img, gray, saturation_factor)


def adjust_hue(img, hue_factor):
    """Shift hue in HSV space by hue_factor (in [-0.5, 0.5]); ref:
    functional.py adjust_hue."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = np.asarray(img)
    is_int = np.issubdtype(img.dtype, np.integer)
    x = img.astype(np.float32) / (255.0 if is_int else 1.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = np.max(x[..., :3], axis=-1)
    mn = np.min(x[..., :3], axis=-1)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    hr = np.where(mx == r, ((g - b) / safe) % 6.0, 0.0)
    hg = np.where((mx == g) & (mx != r), (b - r) / safe + 2.0, 0.0)
    hb = np.where((mx == b) & (mx != r) & (mx != g),
                  (r - g) / safe + 4.0, 0.0)
    hcombined = (hr + hg + hb) / 6.0
    hue = np.where(diff == 0, 0.0, hcombined)
    sat = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    val = mx
    hue = (hue + hue_factor) % 1.0
    i = np.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = val * (1.0 - sat)
    q = val * (1.0 - f * sat)
    t = val * (1.0 - (1.0 - f) * sat)
    i = i.astype(np.int64) % 6
    r2 = np.choose(i, [val, q, p, p, t, val])
    g2 = np.choose(i, [t, val, val, q, p, p])
    b2 = np.choose(i, [p, p, t, val, val, q])
    out = np.stack([r2, g2, b2], axis=-1)
    if is_int:
        return np.clip(np.round(out * 255.0), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    """ref: functional.py normalize."""
    img = np.asarray(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the region [i:i+h, j:j+w] with value(s) v (ref:
    functional.py erase; works on HWC or CHW arrays)."""
    img = np.asarray(img)
    out = img if inplace else img.copy()
    if out.ndim == 3 and out.shape[0] in (1, 3) and out.shape[2] not in \
            (1, 3):
        out[:, i:i + h, j:j + w] = v  # CHW
    else:
        out[i:i + h, j:j + w] = v
    return out


# ---------------------------------------------------------------------------
# random / photometric transform classes
# ---------------------------------------------------------------------------

class RandomResizedCrop(BaseTransform):
    """Random area+aspect crop resized to ``size``
    (ref: transforms.py RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        import math as _m
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            log_r = (_m.log(self.ratio[0]), _m.log(self.ratio[1]))
            ar = _m.exp(random.uniform(*log_r))
            cw = int(round(_m.sqrt(target * ar)))
            ch = int(round(_m.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                return resize(crop(img, i, j, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size,
                      self.interpolation)


class BrightnessTransform(BaseTransform):
    """ref: transforms.py BrightnessTransform(value): factor uniform in
    [max(0, 1-value), 1+value]."""

    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order
    (ref: transforms.py ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for k in order:
            img = self.ts[k]._apply_image(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        return rotate(img, random.uniform(*self.degrees), fill=self.fill)


class RandomAffine(BaseTransform):
    """ref: transforms.py RandomAffine(degrees, translate, scale,
    shear)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill

    def _apply_image(self, img):
        h, w = img.shape[:2]
        angle = random.uniform(*self.degrees)
        if self.translate is not None:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        else:
            tx = ty = 0.0
        sc = random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None:
            shear = (0.0, 0.0)
        elif isinstance(self.shear, numbers.Number):
            shear = (random.uniform(-self.shear, self.shear), 0.0)
        elif len(self.shear) == 2:
            shear = (random.uniform(self.shear[0], self.shear[1]), 0.0)
        else:
            shear = (random.uniform(self.shear[0], self.shear[1]),
                     random.uniform(self.shear[2], self.shear[3]))
        return affine(img, angle, (tx, ty), sc, shear, fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        d = self.distortion_scale
        hw, hh = int(w * d / 2), int(h * d / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(random.randint(0, hw), random.randint(0, hh)),
               (w - 1 - random.randint(0, hw), random.randint(0, hh)),
               (w - 1 - random.randint(0, hw),
                h - 1 - random.randint(0, hh)),
               (random.randint(0, hw), h - 1 - random.randint(0, hh))]
        return perspective(img, start, end, fill=self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    """ref: transforms.py RandomErasing(prob, scale, ratio, value)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        import math as _m
        if random.random() >= self.prob:
            return img
        chw = img.ndim == 3 and img.shape[0] in (1, 3) and \
            img.shape[2] not in (1, 3)
        h, w = (img.shape[1:3] if chw else img.shape[:2])
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            ar = random.uniform(*self.ratio)
            eh = int(round(_m.sqrt(target * ar)))
            ew = int(round(_m.sqrt(target / ar)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                if self.value == "random":
                    v = np.random.normal(
                        size=((img.shape[0], eh, ew) if chw
                              else (eh, ew) + img.shape[2:]))
                else:
                    v = self.value
                return erase(img, i, j, eh, ew, v, self.inplace)
        return img


__all__ += [
    "RandomResizedCrop", "BrightnessTransform", "SaturationTransform",
    "ContrastTransform", "HueTransform", "ColorJitter", "RandomAffine",
    "RandomRotation", "RandomPerspective", "Grayscale", "RandomErasing",
    "to_tensor", "hflip", "vflip", "resize", "pad", "affine", "rotate",
    "perspective", "to_grayscale", "crop", "center_crop",
    "adjust_brightness", "adjust_contrast", "adjust_saturation",
    "adjust_hue", "normalize", "erase",
]
