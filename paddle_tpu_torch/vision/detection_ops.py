"""Detection ops of the port: YOLO decode and loss, SSD priors, the ROI
pooling family, deformable convolution, FPN routing, RPN proposals,
matrix NMS and image IO.

The port of ``paddle_tpu/vision/detection_ops.py``, with its split: the
dense decode and loss math runs on the tensor's device in plain PyTorch
(``yolo_box``, ``yolo_loss``, ``deform_conv2d``, ``roi_pool``,
``psroi_pool``), differentiable; the ops whose output size depends on
the data (``distribute_fpn_proposals``, ``generate_proposals``,
``matrix_nms``) and ``prior_box`` run on the host in numpy and return
their results on the input's device. Each op keeps the JAX function's
arithmetic, quirks included: ``roi_pool`` and ``psroi_pool`` read only
the first image and take a fixed 4×4 grid of samples a bin;
``deform_conv2d`` clips a sample's far corners to the padded border.

``deform_conv2d`` samples each kernel tap bilinearly (one flat gather a
corner) and contracts the columns with the weights as one matmul; it
is not torchvision's op. ``decode_jpeg`` imports PIL when it is called.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.autograd import apply_op
from ..core.tensor import Tensor, as_torch
from ..nn.layer import Layer

__all__ = [
    "yolo_loss", "yolo_box", "prior_box", "deform_conv2d",
    "DeformConv2D", "distribute_fpn_proposals", "generate_proposals",
    "read_file", "decode_jpeg", "roi_pool", "RoIPool", "psroi_pool",
    "PSRoIPool", "RoIAlign", "matrix_nms",
]


def _np_of(t):
    if isinstance(t, (Tensor, torch.Tensor)):
        t = as_torch(t).detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(t)


def _host_out(arrays, like):
    """numpy results of a host op as tensors on ``like``'s device
    (Tensors when ``like`` is one, or is not a tensor: then on the
    current device)."""
    from ..core.device import current_device
    if isinstance(like, (Tensor, torch.Tensor)):
        dev = as_torch(like).device
    else:
        dev = current_device()
    wrap = not isinstance(like, torch.Tensor)

    def one(a):
        t = torch.from_numpy(np.array(a, order="C")).to(dev)
        return Tensor(t) if wrap else t
    return [one(a) for a in arrays]


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------

def _yolo_box(xa, imgs, *, anchors, class_num, conf_thresh,
              downsample_ratio, clip_bbox, scale_x_y, iou_aware,
              iou_aware_factor):
    s = len(anchors) // 2
    n, _, h, w = xa.shape
    dev = xa.device
    an = torch.tensor(anchors, dtype=torch.float32, device=dev).reshape(s, 2)
    if iou_aware:
        ioup, xa_ = xa[:, :s], xa[:, s:]
    else:
        ioup, xa_ = None, xa
    p = xa_.reshape(n, s, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(p[:, :, 0]) * scale_x_y - bias
          + gx[None, None, None, :]) / w
    cy = (torch.sigmoid(p[:, :, 1]) * scale_x_y - bias
          + gy[None, None, :, None]) / h
    bw = torch.exp(p[:, :, 2]) * an[None, :, 0, None, None] \
        / (w * downsample_ratio)
    bh = torch.exp(p[:, :, 3]) * an[None, :, 1, None, None] \
        / (h * downsample_ratio)
    conf = torch.sigmoid(p[:, :, 4])
    if iou_aware:
        iou_p = torch.sigmoid(ioup.reshape(n, s, h, w))
        conf = conf ** (1 - iou_aware_factor) * iou_p ** iou_aware_factor
    cls = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    im_h = imgs[:, 0].float()[:, None, None, None]
    im_w = imgs[:, 1].float()[:, None, None, None]
    x1 = (cx - bw / 2) * im_w
    y1 = (cy - bh / 2) * im_h
    x2 = (cx + bw / 2) * im_w
    y2 = (cy + bh / 2) * im_h
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), im_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), im_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), im_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), im_h - 1)
    keep = conf > conf_thresh
    boxes = torch.stack([x1, y1, x2, y2], dim=2)
    boxes = torch.where(keep[:, :, None], boxes, 0.0)
    cls = torch.where(keep[:, :, None], cls, 0.0)
    boxes = boxes.permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
    cls = cls.permute(0, 3, 4, 1, 2).reshape(n, -1, class_num)
    return boxes, cls


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head ``[N, S·(5 + C), H, W]`` into ``(boxes
    [N, H·W·S, 4]`` xyxy in image pixels, ``scores [N, H·W·S, C])``;
    predictions below ``conf_thresh`` give zeros."""
    return apply_op(_yolo_box, x, img_size, anchors=list(anchors),
                    class_num=class_num, conf_thresh=conf_thresh,
                    downsample_ratio=downsample_ratio, clip_bbox=clip_bbox,
                    scale_x_y=scale_x_y, iou_aware=iou_aware,
                    iou_aware_factor=iou_aware_factor, op_name="yolo_box")


def _bce(logit, target):
    return torch.clamp(logit, min=0) - logit * target + \
        torch.log1p(torch.exp(-logit.abs()))


def _box_iou(ax, ay, aw2, ah2, bx, by, bw2, bh2):
    ax1, ax2 = ax - aw2 / 2, ax + aw2 / 2
    ay1, ay2 = ay - ah2 / 2, ay + ah2 / 2
    bx1, bx2 = bx - bw2 / 2, bx + bw2 / 2
    by1, by2 = by - bh2 / 2, by + bh2 / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    return inter / torch.clamp(aw2 * ah2 + bw2 * bh2 - inter, min=1e-10)


def _yolo_loss(xa, gb, gl, gs=None, *, all_an, mask_an, anchor_mask,
               class_num, ignore_thresh, downsample_ratio,
               use_label_smooth):
    s = len(anchor_mask)
    n, _, h, w = xa.shape
    dev = xa.device
    f32 = torch.float32
    p = xa.reshape(n, s, 5 + class_num, h, w)
    img_w = w * downsample_ratio
    img_h = h * downsample_ratio
    an = torch.as_tensor(mask_an, device=dev)
    gb = gb.float()
    gx = gb[..., 0] / img_w
    gy = gb[..., 1] / img_h
    gw = gb[..., 2] / img_w
    gh = gb[..., 3] / img_h
    valid = (gw > 0) & (gh > 0)
    gi = (gx * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gy * h).to(torch.int32).clamp(0, h - 1).long()
    awh = torch.as_tensor(all_an, device=dev) / torch.tensor(
        [img_w, img_h], dtype=f32, device=dev)
    inter = (torch.minimum(gw[..., None], awh[None, None, :, 0])
             * torch.minimum(gh[..., None], awh[None, None, :, 1]))
    union = (gw * gh)[..., None] + awh[:, 0] * awh[:, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=-1)
    mask_arr = torch.as_tensor(np.asarray(anchor_mask), device=dev)
    hit = best[..., None] == mask_arr
    in_mask = hit.any(-1) & valid
    slot = torch.argmax(hit.to(torch.int32), dim=-1)

    bidx = torch.arange(n, device=dev)[:, None].expand_as(gi)
    sel = (bidx, slot, gj, gi)
    wgt = gs.float() if gs is not None else torch.ones_like(gx)

    def upd(v):
        t = torch.zeros((n, s, h, w), dtype=f32, device=dev)
        return t.index_put(sel, torch.where(in_mask, v, 0.0).to(f32),
                           accumulate=True)
    obj_t = upd(torch.ones_like(gx) * wgt)
    tx = upd(gx * w - gi)
    ty = upd(gy * h - gj)
    tw = upd(torch.log(torch.clamp(
        gw * img_w / torch.clamp(an[slot, 0], min=1e-6), min=1e-6)))
    th = upd(torch.log(torch.clamp(
        gh * img_h / torch.clamp(an[slot, 1], min=1e-6), min=1e-6)))
    tscale = upd(2.0 - gw * gh)
    tcls = torch.zeros((n, s, class_num, h, w), dtype=f32, device=dev)
    tcls = tcls.index_put((bidx, slot, gl.long(), gj, gi),
                          torch.where(in_mask, 1.0, 0.0), accumulate=True)
    obj_mask = (obj_t > 0).to(f32)

    px = (torch.sigmoid(p[:, :, 0])
          + torch.arange(w, dtype=f32, device=dev)) / w
    py = (torch.sigmoid(p[:, :, 1])
          + torch.arange(h, dtype=f32, device=dev)[:, None]) / h
    pw = torch.exp(p[:, :, 2].clamp(-10, 10)) * \
        an[None, :, 0, None, None] / img_w
    ph = torch.exp(p[:, :, 3].clamp(-10, 10)) * \
        an[None, :, 1, None, None] / img_h
    g5 = (slice(None), None, None, None, slice(None))
    ious = _box_iou(px[..., None], py[..., None], pw[..., None],
                    ph[..., None], gx[g5], gy[g5], gw[g5], gh[g5])
    ious = torch.where(valid[g5], ious, 0.0)
    best_iou = ious.amax(-1)
    noobj_mask = (best_iou < ignore_thresh).to(f32) * (1.0 - obj_mask)

    delta = 0.1 / class_num if (use_label_smooth and class_num > 1) \
        else 0.0
    tcls_s = tcls * (1.0 - delta) + delta / max(class_num, 1)
    loss_xy = ((_bce(p[:, :, 0], tx) + _bce(p[:, :, 1], ty))
               * obj_mask * tscale).sum((1, 2, 3))
    loss_wh = (((p[:, :, 2] - tw).abs() + (p[:, :, 3] - th).abs())
               * obj_mask * tscale).sum((1, 2, 3))
    loss_obj = (_bce(p[:, :, 4], obj_t) * (obj_mask + noobj_mask)) \
        .sum((1, 2, 3))
    loss_cls = (_bce(p[:, :, 5:], tcls_s) * obj_mask[:, :, None]) \
        .sum((1, 2, 3, 4))
    return loss_xy + loss_wh + loss_obj + loss_cls


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's training loss a batch element ``[N]``: BCE on the
    sigmoid x/y and L1 on w/h of the matched anchor (weighted by
    ``2 - w·h``), objectness BCE outside the ``ignore_thresh`` region,
    class BCE (label-smoothed). ``gt_box [N, B, 4]`` is (cx, cy, w, h)
    in image pixels, ``gt_label [N, B]``; each ground truth goes to its
    best anchor of the full set when that anchor is in this head's
    mask."""
    all_an = np.asarray(anchors, np.float32).reshape(-1, 2)
    return apply_op(_yolo_loss, x, gt_box, gt_label, gt_score,
                    all_an=all_an, mask_an=all_an[np.asarray(anchor_mask)],
                    anchor_mask=list(anchor_mask), class_num=class_num,
                    ignore_thresh=ignore_thresh,
                    downsample_ratio=downsample_ratio,
                    use_label_smooth=use_label_smooth, op_name="yolo_loss")


# ---------------------------------------------------------------------------
# SSD priors
# ---------------------------------------------------------------------------

def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD priors: ``(boxes [H, W, P, 4]`` normalised xyxy,
    ``variances`` of the same shape``)``, computed on the host from the
    feature map's and the image's sizes."""
    h, w = int(input.shape[2]), int(input.shape[3])
    im_h, im_w = int(image.shape[2]), int(image.shape[3])
    if isinstance(min_sizes, (int, float)):
        min_sizes = [min_sizes]
    if isinstance(max_sizes, (int, float)):
        max_sizes = [max_sizes]
    if isinstance(aspect_ratios, (int, float)):
        aspect_ratios = [aspect_ratios]
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - e) > 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    step_w = steps[0] or im_w / w
    step_h = steps[1] or im_h / h
    whs = []
    for k, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                big = math.sqrt(ms * max_sizes[k])
                whs.append((big, big))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                big = math.sqrt(ms * max_sizes[k])
                whs.append((big, big))
    whs_np = np.asarray(whs, np.float32)
    cx = (np.arange(w, dtype=np.float32) + offset) * step_w
    cy = (np.arange(h, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.empty((h, w, len(whs), 4), np.float32)
    boxes[..., 0] = (cxg[:, :, None] - whs_np[:, 0] / 2) / im_w
    boxes[..., 1] = (cyg[:, :, None] - whs_np[:, 1] / 2) / im_h
    boxes[..., 2] = (cxg[:, :, None] + whs_np[:, 0] / 2) / im_w
    boxes[..., 3] = (cyg[:, :, None] + whs_np[:, 1] / 2) / im_h
    if clip:
        boxes = boxes.clip(0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    return tuple(_host_out([boxes, var], input))


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

def _deform_conv2d(xa, off, wgt, m=None, *, stride, padding, dilation):
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    n, c, h, w = xa.shape
    co, ci, kh, kw = wgt.shape
    k = kh * kw
    dev = xa.device
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = torch.nn.functional.pad(xa, (pw, pw, ph, ph))
    hp, wp = h + 2 * ph, w + 2 * pw
    off_r = off.reshape(n, k, 2, oh, ow)
    base_y = (torch.arange(oh, device=dev) * sh)[None, :, None]
    base_x = (torch.arange(ow, device=dev) * sw)[None, None, :]
    ky = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)[
        :, None, None]
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)[:, None, None]
    ys = base_y + ky + off_r[:, :, 0]
    xs = base_x + kx + off_r[:, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    valid = (ys > -1) & (ys < hp) & (xs > -1) & (xs < wp)
    flat_x = xp.reshape(n, c, hp * wp)

    def gather(yy, xx):
        yc = yy.clamp(0, hp - 1).long()
        xc = xx.clamp(0, wp - 1).long()
        idx = (yc * wp + xc).reshape(n, 1, -1).expand(n, c, -1)
        return flat_x.gather(2, idx).reshape(n, c, k, oh, ow)

    sampled = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    sampled = torch.where(valid[:, None], sampled, 0.0)
    if m is not None:
        sampled = sampled * m.reshape(n, 1, k, oh, ow)
    cols = sampled.reshape(n, c * k, oh * ow)
    out = torch.matmul(wgt.reshape(co, ci * k), cols)
    return out.reshape(n, co, oh, ow)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1, and v2 with ``mask``: each kernel tap
    reads the input bilinearly at its grid point plus its learned
    ``offset [N, 2·kh·kw, OH, OW]`` (``(dy, dx)`` a tap), scaled by
    ``mask [N, kh·kw, OH, OW]``; then one matmul with the weights."""
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d: groups/deformable_groups > 1 unsupported")
    out = apply_op(_deform_conv2d, x, offset, weight, mask,
                   stride=_pair(stride), padding=_pair(padding),
                   dilation=_pair(dilation), op_name="deform_conv2d")
    if bias is not None:
        out = out + bias.reshape([1, -1, 1, 1])
    return out


class DeformConv2D(Layer):
    """A layer over :func:`deform_conv2d`: weight ``[out, in / groups,
    kh, kw]`` uniform in ``±1/√(in·kh·kw)``, zero bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from ..nn import initializer as I
        kh, kw = _pair(kernel_size)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw],
            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_channels], attr=False if bias_attr is False else None,
            is_bias=True)
        self._cfg = dict(stride=stride, padding=padding,
                         dilation=dilation,
                         deformable_groups=deformable_groups,
                         groups=groups)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             mask=mask, **self._cfg)


# ---------------------------------------------------------------------------
# ROI pooling family
# ---------------------------------------------------------------------------

_SAMPLES = 4    # samples a bin edge in roi_pool / psroi_pool


def _bin_samples(img, bxs, oh, ow, spatial_scale, rounded):
    """Each box's ``4·oh × 4·ow`` sample grid of ``img [C, H, W]``:
    ``[C, R, oh, 4, ow, 4]``."""
    c, h, w = img.shape
    x1 = bxs[:, 0] * spatial_scale
    y1 = bxs[:, 1] * spatial_scale
    x2 = bxs[:, 2] * spatial_scale
    y2 = bxs[:, 3] * spatial_scale
    if rounded:
        x1, y1 = torch.round(x1), torch.round(y1)
        x2 = torch.maximum(torch.round(x2), x1 + 1)
        y2 = torch.maximum(torch.round(y2), y1 + 1)
    bh = (y2 - y1) / oh
    bw = (x2 - x1) / ow
    dev = img.device
    sy = (torch.arange(oh * _SAMPLES, device=dev) + 0.5) / _SAMPLES
    sx = (torch.arange(ow * _SAMPLES, device=dev) + 0.5) / _SAMPLES
    ys = y1[:, None] + sy[None, :] * bh[:, None]
    xs = x1[:, None] + sx[None, :] * bw[:, None]
    yi = ys.to(torch.int32).clamp(0, h - 1).long()
    xi = xs.to(torch.int32).clamp(0, w - 1).long()
    vals = img[:, yi[:, :, None], xi[:, None, :]]
    return vals.reshape(c, bxs.shape[0], oh, _SAMPLES, ow, _SAMPLES)


def _roi_pool(feat, bxs, *, oh, ow, spatial_scale):
    vals = _bin_samples(feat[0], bxs, oh, ow, spatial_scale, True)
    return vals.amax((3, 5)).permute(1, 0, 2, 3)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max over each bin's 4×4 samples of the first image of ``x``:
    ``[R, C, oh, ow]`` for ``boxes [R, 4]`` (xyxy, rounded after
    ``spatial_scale``)."""
    oh, ow = _pair(output_size)
    return apply_op(_roi_pool, x, boxes, oh=oh, ow=ow,
                    spatial_scale=spatial_scale, op_name="roi_pool")


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def _psroi_pool(feat, bxs, *, oh, ow, spatial_scale):
    vals = _bin_samples(feat[0], bxs, oh, ow, spatial_scale, False)
    c, r = vals.shape[:2]
    avg = vals.mean((3, 5)).reshape(c // (oh * ow), oh, ow, r, oh, ow)
    ii = torch.arange(oh, device=feat.device)[:, None]
    jj = torch.arange(ow, device=feat.device)[None, :]
    out = avg[:, ii, jj, :, ii, jj]           # [oh, ow, out_c, R]
    return out.permute(3, 2, 0, 1)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive ROI average pooling (R-FCN): input channels
    ``out_c·oh·ow``; bin ``(i, j)`` of output channel ``k`` averages
    the 4×4 samples of input channel ``k·oh·ow + i·ow + j``."""
    oh, ow = _pair(output_size)
    return apply_op(_psroi_pool, x, boxes, oh=oh, ow=ow,
                    spatial_scale=spatial_scale, op_name="psroi_pool")


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


class RoIAlign(Layer):
    """A layer over :func:`~.ops.roi_align`."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        from .ops import roi_align
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


# ---------------------------------------------------------------------------
# host-side proposal machinery
# ---------------------------------------------------------------------------

def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Route ROIs to FPN levels by scale: ``floor(refer_level +
    log2(√area / refer_scale))`` clipped to the levels. Returns the
    per-level ROIs, the restore index ``[R, 1]`` and the per-level
    counts."""
    rois = _np_of(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(ws * hs, 1e-12))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-12))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, nums, parts = [], [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        outs.append(rois[idx])
        nums.append(np.asarray([len(idx)], np.int32))
        parts.append(idx)
    order = np.concatenate(parts) if parts else np.empty(0, np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    outs = _host_out(outs, fpn_rois)
    restore_t, = _host_out([restore.reshape(-1, 1)], fpn_rois)
    return outs, restore_t, _host_out(nums, fpn_rois)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True,
                       name=None):
    """RPN proposals an image: decode the anchor deltas, clip to the
    image, drop the small ones, NMS, keep the top ``post_nms_top_n``."""
    from .ops import _nms_indices
    sc = _np_of(scores)
    bd = _np_of(bbox_deltas)
    im = _np_of(img_size)
    an = _np_of(anchors).reshape(-1, 4)
    var = _np_of(variances).reshape(-1, 4)
    all_rois, all_scores, all_nums = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for i in range(sc.shape[0]):
        s = sc[i].transpose(1, 2, 0).reshape(-1)
        d = bd[i].transpose(1, 2, 0).reshape(-1, 4)
        order = np.argsort(-s)[:int(pre_nms_top_n)]
        s, d, a, v = s[order], d[order], an[order % len(an)], \
            var[order % len(var)]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        bw = aw * np.exp(np.minimum(v[:, 2] * d[:, 2], 10.0))
        bh = ah * np.exp(np.minimum(v[:, 3] * d[:, 3], 10.0))
        boxes = np.stack([cx - bw / 2, cy - bh / 2,
                          cx + bw / 2 - off, cy + bh / 2 - off], axis=1)
        ih, iw = im[i, 0], im[i, 1]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, iw - off)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ih - off)
        keep_sz = ((boxes[:, 2] - boxes[:, 0] + off >= min_size)
                   & (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes, s = boxes[keep_sz], s[keep_sz]
        keep = _nms_indices(boxes, s, nms_thresh)[:int(post_nms_top_n)]
        all_rois.append(boxes[keep])
        all_scores.append(s[keep])
        all_nums.append(len(keep))
    rois = np.concatenate(all_rois) if all_rois else np.empty((0, 4))
    score_out = np.concatenate(all_scores) if all_scores \
        else np.empty(0, np.float32)
    out = _host_out([rois.astype(np.float32), score_out.astype(np.float32),
                     np.asarray(all_nums, np.int32)], scores)
    return tuple(out) if return_rois_num else tuple(out[:2])


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each box's score decays by its IoU with the
    higher-scored boxes of its class instead of being suppressed.
    Returns ``(out [K, 6]`` of (class, score, x1, y1, x2, y2), the
    index or None, the counts an image``)``."""
    b = _np_of(bboxes)
    s = _np_of(scores)
    outs, idxs, nums = [], [], []
    for i in range(s.shape[0]):
        dets = []
        for c in range(s.shape[1]):
            if c == background_label:
                continue
            sc = s[i, c]
            sel = np.nonzero(sc > score_threshold)[0]
            if len(sel) == 0:
                continue
            order = sel[np.argsort(-sc[sel])][:int(nms_top_k)]
            bs, ss = b[i][order], sc[order]
            x1 = np.maximum(bs[:, None, 0], bs[None, :, 0])
            y1 = np.maximum(bs[:, None, 1], bs[None, :, 1])
            x2 = np.minimum(bs[:, None, 2], bs[None, :, 2])
            y2 = np.minimum(bs[:, None, 3], bs[None, :, 3])
            off = 0.0 if normalized else 1.0
            iw = np.maximum(x2 - x1 + off, 0)
            ih = np.maximum(y2 - y1 + off, 0)
            inter = iw * ih
            area = ((bs[:, 2] - bs[:, 0] + off)
                    * (bs[:, 3] - bs[:, 1] + off))
            iou = inter / np.maximum(
                area[:, None] + area[None, :] - inter, 1e-10)
            iou = np.triu(iou, 1)
            comp = iou.max(axis=0)
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                               / gaussian_sigma).min(axis=0)
            else:
                decay = ((1 - iou) / np.maximum(1 - comp[:, None],
                                                1e-10)).min(axis=0)
            new_s = ss * np.minimum(decay, 1.0)
            for j in np.nonzero(new_s > post_threshold)[0]:
                dets.append((c, new_s[j], *bs[j], order[j]))
        dets.sort(key=lambda t: -t[1])
        if keep_top_k > 0:
            dets = dets[:int(keep_top_k)]
        outs.append(np.asarray([d[:6] for d in dets], np.float32)
                    if dets else np.empty((0, 6), np.float32))
        idxs.append(np.asarray([d[6] for d in dets], np.int64)
                    if dets else np.empty(0, np.int64))
        nums.append(len(dets))
    out, index, rois_num = _host_out(
        [np.concatenate(outs) if outs else np.empty((0, 6), np.float32),
         np.concatenate(idxs) if idxs else np.empty(0, np.int64),
         np.asarray(nums, np.int32)], bboxes)
    index = index if return_index else None
    return (out, index, rois_num) if return_rois_num else (out, index)


# ---------------------------------------------------------------------------
# image IO
# ---------------------------------------------------------------------------

def read_file(filename, name=None):
    """A file's bytes as a uint8 Tensor on the current device."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    return _host_out([data], None)[0]


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG bytes -> a CHW uint8 tensor on ``x``'s device, decoded on
    the host by PIL (imported here)."""
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(_np_of(x).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _host_out([arr], x)[0]
