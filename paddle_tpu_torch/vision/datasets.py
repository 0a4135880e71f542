"""Built-in datasets (the port's copy of ``paddle_tpu/vision/datasets.py``).

ref: python/paddle/vision/datasets/ (MNIST, CIFAR, Flowers...). Nothing
is downloaded: ``MNIST``, ``FashionMNIST``, ``Cifar10``, ``Cifar100``,
``Flowers`` and ``VOC2012`` generate a deterministic synthetic sample
set with the real shapes and dtypes (HWC uint8 images, int64 labels
``[1]``), the same arrays as the JAX package's. ``DatasetFolder`` and
``ImageFolder`` read local files through PIL, imported at first use.
"""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012"]


class _SyntheticImageDataset(Dataset):
    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10
    NUM_SAMPLES = 1024

    def __init__(self, mode="train", transform=None, backend=None,
                 image_path=None, label_path=None, data_file=None,
                 download=True):
        self.mode = mode
        self.transform = transform
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = self.NUM_SAMPLES if mode == "train" else self.NUM_SAMPLES // 4
        self.images = rng.integers(
            0, 256, size=(n,) + self.IMAGE_SHAPE[1:] +
            ((self.IMAGE_SHAPE[0],) if self.IMAGE_SHAPE[0] > 1 else ()),
            dtype=np.uint8)
        self.labels = rng.integers(0, self.NUM_CLASSES, size=(n, 1),
                                   dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)
            if img.ndim == 2:
                img = img[None]
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class MNIST(_SyntheticImageDataset):
    """ref: vision/datasets/mnist.py."""
    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10


class FashionMNIST(MNIST):
    pass


class Cifar10(_SyntheticImageDataset):
    """ref: vision/datasets/cifar.py."""
    IMAGE_SHAPE = (3, 32, 32)
    NUM_CLASSES = 10


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(_SyntheticImageDataset):
    """ref: vision/datasets/flowers.py (102-category Oxford flowers)."""
    IMAGE_SHAPE = (3, 96, 96)
    NUM_CLASSES = 102
    NUM_SAMPLES = 512


class VOC2012(Dataset):
    """ref: vision/datasets/voc2012.py — segmentation pairs (image,
    label-mask). Synthetic shapes: [3, H, W] uint8 image, [H, W] int64
    mask over 21 classes (20 + background)."""
    NUM_CLASSES = 21

    def __init__(self, mode="train", transform=None, backend=None,
                 data_file=None, download=True):
        self.mode = mode
        self.transform = transform
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = 128 if mode == "train" else 32
        self.images = rng.integers(0, 256, size=(n, 3, 64, 64),
                                   dtype=np.uint8)
        self.masks = rng.integers(0, self.NUM_CLASSES, size=(n, 64, 64),
                                  dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                   ".tif", ".tiff", ".webp")


def _scan_files(root, extensions, is_valid_file):
    """Sorted recursive file scan shared by DatasetFolder/ImageFolder:
    is_valid_file wins when given, else the extension allowlist."""
    import os

    exts = tuple(e.lower() for e in (extensions or _IMG_EXTENSIONS))
    found = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            ok = (is_valid_file(path) if is_valid_file
                  else fname.lower().endswith(exts))
            if ok:
                found.append(path)
    return found


class DatasetFolder(Dataset):
    """Directory-per-class dataset (ref:
    vision/datasets/folder.py DatasetFolder): root/<class>/<file>,
    classes sorted alphabetically, loaded via the configured image
    backend (PIL here)."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        import os

        self.root = root
        self.transform = transform
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            for path in _scan_files(os.path.join(root, c), extensions,
                                    is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"found no valid files under {root}")
        self.loader = loader or self._pil_loader

    @staticmethod
    def _pil_loader(path):
        from PIL import Image
        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat image-file dataset, no labels (ref:
    vision/datasets/folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = _scan_files(root, extensions, is_valid_file)
        if not self.samples:
            raise RuntimeError(f"found no valid files under {root}")
        self.loader = loader or DatasetFolder._pil_loader

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


__all__ += ["DatasetFolder", "ImageFolder"]
