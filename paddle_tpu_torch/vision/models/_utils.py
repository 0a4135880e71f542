"""The vision zoo's pretrained-weight loader, offline only.

The port of ``paddle_tpu/vision/models/_utils.py``. The weights of an
architecture are the file its URL names, found in
``PADDLE_TPU_PRETRAINED_DIR`` (md5-checked) or in the weights cache
(``PADDLE_TPU_WEIGHTS_HOME``, else ``~/.cache/paddle_tpu/weights``),
the places the JAX package's loader looks before it downloads. The
port downloads nothing: without the file it raises, naming both.
"""
from __future__ import annotations

import hashlib
import os
import os.path as osp

__all__ = ["load_pretrained", "pretrained_path", "scale_suffix"]


def scale_suffix(scale) -> str:
    """A width multiplier as the published weight names write it:
    1 / 1.0 -> '1.0', 0.25 -> '0.25'."""
    return str(float(scale))


def _md5(path: str) -> str:
    md5 = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            md5.update(chunk)
    return md5.hexdigest()


def pretrained_path(url: str, md5sum=None) -> str:
    """The local file of ``url``'s weights, or FileNotFoundError."""
    fname = osp.basename(url)
    override = os.environ.get("PADDLE_TPU_PRETRAINED_DIR")
    home = os.environ.get("PADDLE_TPU_WEIGHTS_HOME",
                          osp.expanduser("~/.cache/paddle_tpu/weights"))
    for d in ([override] if override else []) + [home]:
        cand = osp.join(d, fname)
        if osp.isfile(cand):
            if md5sum is not None and _md5(cand) != md5sum:
                raise ValueError(f"{cand} fails its md5 check (expected "
                                 f"{md5sum})")
            return cand
    raise FileNotFoundError(
        f"no local file for the pretrained weights {url}: this package "
        f"does not download; place {fname} in PADDLE_TPU_PRETRAINED_DIR "
        f"or in {home}")


def load_pretrained(model, arch, urls):
    """Install ``arch``'s published weights from a local file, failing
    loudly on a missing arch, a missing file or any mismatched key."""
    if arch not in urls:
        raise ValueError(
            f"{arch} has no published pretrained weights; set "
            f"pretrained=False (available: {sorted(urls)})")
    from ... import framework
    path = pretrained_path(*urls[arch])
    state = framework.io.load(path, return_numpy=True)
    missing, unexpected = model.set_state_dict(state)
    if missing or unexpected:
        raise ValueError(
            f"pretrained weights for {arch} do not match the model: "
            f"missing={list(missing)[:5]}, "
            f"unexpected={list(unexpected)[:5]}")
    return model
