"""``paddle.vision.ops`` of the port: ``nms``, ``roi_align``, the
``box_coder`` placeholder and the detection ops
(:mod:`.detection_ops`).

The port of ``paddle_tpu/vision/ops.py``. ``nms`` runs on the host in
numpy, as the JAX function does, and returns the kept indices as int64
on the boxes' device. ``roi_align`` keeps the JAX function's design:
it reads only the first image of ``x`` and takes one bilinear sample at
each bin's centre, whatever ``sampling_ratio`` says. ``box_coder``
raises ``NotImplementedError``, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.autograd import apply_op
from .detection_ops import (  # noqa: F401
    DeformConv2D, PSRoIPool, RoIAlign, RoIPool, _host_out, _np_of,
    decode_jpeg, deform_conv2d, distribute_fpn_proposals,
    generate_proposals, matrix_nms, prior_box, psroi_pool, read_file,
    roi_pool, yolo_box, yolo_loss)

__all__ = ["nms", "box_coder", "roi_align", "yolo_loss", "yolo_box",
           "prior_box", "deform_conv2d", "DeformConv2D",
           "distribute_fpn_proposals", "generate_proposals",
           "read_file", "decode_jpeg", "roi_pool", "RoIPool",
           "psroi_pool", "PSRoIPool", "RoIAlign", "matrix_nms"]


def _nms_indices(b, s, iou_threshold, top_k=None):
    """Greedy NMS on the host: numpy boxes ``b [N, 4]`` and scores
    ``s [N]`` -> the int64 indices kept, best first."""
    order = np.argsort(-s)
    keep = []
    suppressed = np.zeros(len(b), dtype=bool)
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    for i_ in order:
        if suppressed[i_]:
            continue
        keep.append(int(i_))
        xx1 = np.maximum(b[i_, 0], b[:, 0])
        yy1 = np.maximum(b[i_, 1], b[:, 1])
        xx2 = np.minimum(b[i_, 2], b[:, 2])
        yy2 = np.minimum(b[i_, 3], b[:, 3])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i_] + areas - inter + 1e-10)
        suppressed |= iou > iou_threshold
        suppressed[i_] = True
    if top_k is not None:
        keep = keep[:top_k]
    return np.asarray(keep, dtype=np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS over ``boxes [N, 4]`` (xyxy) in the order of
    ``scores`` (else the given order): the int64 indices kept."""
    b = _np_of(boxes)
    s = _np_of(scores) if scores is not None else \
        np.arange(len(b), 0, -1, dtype=np.float32)
    return _host_out([_nms_indices(b, s, iou_threshold, top_k)], boxes)[0]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    raise NotImplementedError("box_coder lands with the detection suite")


def _roi_align(feat, bxs, *, oh, ow, spatial_scale, aligned):
    h, w = feat.shape[2], feat.shape[3]
    dev = feat.device
    off = 0.5 if aligned else 0.0
    x1 = bxs[:, 0] * spatial_scale - off
    y1 = bxs[:, 1] * spatial_scale - off
    x2 = bxs[:, 2] * spatial_scale - off
    y2 = bxs[:, 3] * spatial_scale - off
    bin_h = (y2 - y1) / oh
    bin_w = (x2 - x1) / ow
    ys = y1[:, None] + (torch.arange(oh, device=dev) + 0.5) * bin_h[:, None]
    xs = x1[:, None] + (torch.arange(ow, device=dev) + 0.5) * bin_w[:, None]
    y0 = torch.floor(ys).clamp(0, h - 1).long()
    x0 = torch.floor(xs).clamp(0, w - 1).long()
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    wy = (ys.clamp(0, h - 1) - y0)[None, :, :, None]
    wx = (xs.clamp(0, w - 1) - x0)[None, :, None, :]
    img = feat[0]

    def at(yi, xi):
        return img[:, yi[:, :, None], xi[:, None, :]]   # [C, R, oh, ow]
    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
           + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return out.permute(1, 0, 2, 3)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """ROI align of the first image of ``x``: ``[R, C, oh, ow]``, each
    bin one bilinear sample at its centre."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    return apply_op(_roi_align, x, boxes, oh=oh, ow=ow,
                    spatial_scale=spatial_scale, aligned=aligned,
                    op_name="roi_align")
