"""The port's detection and ROI ops (``vision.ops``,
``vision.detection_ops``) against the JAX package's, on the CPU.

The device ops take the same seeded f32 inputs on both sides: the
outputs, and the gradient of ``Σ out · w`` (``w`` a fixed random
weighting) with respect to every float input that the op differentiates
(the JAX side one jitted ``value_and_grad``), within
``TOL · (1 + |ref|)``, TOL = 1e-4 (f32; the YOLO loss sums a few
thousand terms). The host ops (``nms``, ``matrix_nms``,
``generate_proposals``, ``distribute_fpn_proposals``, ``prior_box``,
the image IO) must give the JAX results exactly, up to float rounding
of the decoded boxes. The JAX behaviours the port copies are pinned:
``roi_align`` reads only the first image and one sample a bin whatever
``sampling_ratio`` says; ``nms`` returns int64 indices.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _jax_fusion_off():
    """The JAX side traces with its lazy fusion off: a ``jax.jit`` trace
    with it on leaves state that breaks later traces in the process
    (``test_semi_auto.py``, ``test_pipeline_tied.py``)."""
    prev = jpaddle.get_flags("FLAGS_eager_fusion")
    jpaddle.set_flags({"FLAGS_eager_fusion": False})
    yield
    jpaddle.set_flags(prev)

TOL = 1e-4
_R = np.random.default_rng(21)


def _f(*shape, scale=1.0):
    return (_R.standard_normal(shape) * scale).astype(np.float32)


def V(P):
    return P.vision.ops


def _boxes(n, h, w, seed):
    r = np.random.default_rng(seed)
    x1 = r.uniform(0, w * 0.7, n)
    y1 = r.uniform(0, h * 0.7, n)
    bw = r.uniform(1.5, w * 0.3, n)
    bh = r.uniform(1.5, h * 0.3, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def _np(v):
    if isinstance(v, jpaddle.Tensor):
        return np.asarray(v._data)
    if isinstance(v, tpaddle.Tensor):
        return v.numpy()
    return np.asarray(v)


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert (err <= 0).all(), (what, float(np.abs(got - want).max()))


def _outs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def _run_jax(fn, arrays, diff, ws):
    def loss(*arrs):
        outs = _outs(fn(jpaddle, *[jpaddle.Tensor(a) for a in arrs]))
        outs = [o._data for o in outs]
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(diff), has_aux=True))(*arrays)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _both(name, fn, arrays, diff):
    ts = [tpaddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    outs = _outs(fn(tpaddle, *ts))
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    total = None
    for o, w in zip(outs, ws):
        term = (o * tpaddle.to_tensor(w)).sum()
        total = term if total is None else total + term
    total.backward()
    want, jgrads = _run_jax(fn, arrays, diff, ws)
    for i, (o, w) in enumerate(zip(outs, want)):
        _close(o.numpy(), w, f"{name} out {i}")
    for i, g in zip(diff, jgrads):
        _close(ts[i].grad.numpy(), g, f"{name} grad {i}")


FEAT = _f(2, 8, 20, 24)
ROIS = _boxes(6, 40, 48, 1)
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
C = 5                                   # classes of the YOLO cases
HEAD = _f(2, 3 * (5 + C), 6, 8, scale=0.5)
IMG = np.asarray([[192, 256], [160, 200]], np.int32)


def _gt(n=2, b=4, w=256, h=192, seed=4):
    r = np.random.default_rng(seed)
    box = np.stack([r.uniform(20, w - 20, (n, b)), r.uniform(20, h - 20,
                                                             (n, b)),
                    r.uniform(8, 120, (n, b)), r.uniform(8, 100, (n, b))],
                   -1).astype(np.float32)
    box[1, -1] = 0.0                    # a padded ground truth
    return box, r.integers(0, C, (n, b)).astype(np.int32), \
        r.uniform(0.5, 1.0, (n, b)).astype(np.float32)


GT_BOX, GT_LABEL, GT_SCORE = _gt()

DEVICE_OPS = [
    ("roi_align", lambda P, x, b: V(P).roi_align(x, b, None, 3,
                                                spatial_scale=0.5),
     [FEAT, ROIS], [0, 1]),
    ("roi_align_unaligned", lambda P, x, b: V(P).roi_align(
        x, b, None, (2, 4), spatial_scale=0.5, aligned=False),
     [FEAT, ROIS], [0]),
    ("roi_align_layer", lambda P, x, b: V(P).RoIAlign(3, 0.5)(x, b, None),
     [FEAT, ROIS], [0]),
    ("roi_pool", lambda P, x, b: V(P).roi_pool(x, b, None, 3,
                                              spatial_scale=0.5),
     [FEAT, ROIS], [0]),
    ("roi_pool_layer", lambda P, x, b: V(P).RoIPool((2, 3), 0.5)(x, b, None),
     [FEAT, ROIS], [0]),
    ("psroi_pool", lambda P, x, b: V(P).psroi_pool(x, b, None, 2,
                                                  spatial_scale=0.5),
     [FEAT, ROIS], [0]),
    ("psroi_pool_layer", lambda P, x, b: V(P).PSRoIPool(2, 0.5)(x, b, None),
     [FEAT, ROIS], [0]),
    ("deform_conv2d", lambda P, x, o, w, b: V(P).deform_conv2d(
        x, o, w, b, padding=1),
     [_f(2, 4, 7, 8), _f(2, 18, 7, 8), _f(6, 4, 3, 3), _f(6)], [0, 1, 2, 3]),
    ("deform_conv2d_mask_stride_dilation", lambda P, x, o, w, m:
     V(P).deform_conv2d(x, o, w, stride=2, padding=2, dilation=2, mask=m),
     [_f(2, 4, 9, 9), _f(2, 18, 5, 5, scale=2.0), _f(3, 4, 3, 3),
      np.abs(_f(2, 9, 5, 5))], [0, 1, 2, 3]),
    ("yolo_box", lambda P, x, s: V(P).yolo_box(
        x, s, ANCHORS[:6], C, 0.4, 32), [HEAD, IMG], [0]),
    ("yolo_box_no_clip_scaled", lambda P, x, s: V(P).yolo_box(
        x, s, ANCHORS[:6], C, 0.3, 16, clip_bbox=False, scale_x_y=1.05),
     [HEAD, IMG], [0]),
    ("yolo_box_iou_aware", lambda P, x, s: V(P).yolo_box(
        x, s, ANCHORS[:6], C, 0.2, 32, iou_aware=True,
        iou_aware_factor=0.4),
     [_f(2, 3 * (6 + C), 6, 8, scale=0.5), IMG], [0]),
    ("yolo_loss", lambda P, x, gb, gl: V(P).yolo_loss(
        x, gb, gl, ANCHORS, [0, 1, 2], C, 0.7, 32),
     [HEAD, GT_BOX, GT_LABEL], [0]),
    ("yolo_loss_score_no_smooth", lambda P, x, gb, gl, gs: V(P).yolo_loss(
        x, gb, gl, ANCHORS, [3, 4, 5], C, 0.5, 32, gt_score=gs,
        use_label_smooth=False),
     [HEAD, GT_BOX, GT_LABEL, GT_SCORE], [0]),
]


@pytest.mark.parametrize("name,fn,arrays,diff", DEVICE_OPS,
                         ids=[d[0] for d in DEVICE_OPS])
def test_device_op_matches_jax_forward_and_gradient(name, fn, arrays, diff):
    _both(name, fn, arrays, diff)


def test_deform_conv2d_layer_matches_jax():
    x, off, m = _f(2, 4, 6, 6), _f(2, 18, 6, 6), np.abs(_f(2, 9, 6, 6))
    tpaddle.seed(3)
    tl = tpaddle.vision.ops.DeformConv2D(4, 5, 3, padding=1)
    jl = jpaddle.vision.ops.DeformConv2D(4, 5, 3, padding=1)
    assert set(tl.state_dict()) == set(jl.state_dict()) == {"weight",
                                                            "bias"}
    w = tl.weight.numpy()
    bound = 1.0 / np.sqrt(4 * 9)
    assert np.abs(w).max() <= bound and not tl.bias.numpy().any()
    b = _f(5)
    jl.set_state_dict({"weight": w, "bias": b})
    tl.set_state_dict({"weight": w, "bias": b})
    got = tl(tpaddle.to_tensor(x), tpaddle.to_tensor(off),
             tpaddle.to_tensor(m))
    want = jl(jpaddle.to_tensor(x), jpaddle.to_tensor(off),
              jpaddle.to_tensor(m))
    _close(got.numpy(), _np(want), "DeformConv2D")
    nb = tpaddle.vision.ops.DeformConv2D(4, 5, (3, 3), bias_attr=False)
    assert nb.bias is None


def test_roi_align_reads_the_first_image_once_a_bin():
    """The JAX quirks the port copies: the second image of the batch
    is never read, and ``sampling_ratio`` changes nothing."""
    x = FEAT.copy()
    other = x.copy()
    other[1] = _f(8, 20, 24)
    ops = tpaddle.vision.ops
    a = ops.roi_align(tpaddle.to_tensor(x), tpaddle.to_tensor(ROIS),
                      None, 3, 0.5)
    b = ops.roi_align(tpaddle.to_tensor(other), tpaddle.to_tensor(ROIS),
                      None, 3, 0.5, sampling_ratio=4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jpaddle.vision.ops.roi_align(jpaddle.to_tensor(other),
                                        jpaddle.to_tensor(ROIS), None, 3,
                                        0.5, sampling_ratio=4)
    _close(b.numpy(), _np(want), "roi_align")


@pytest.mark.parametrize("kwargs", [dict(iou_threshold=0.3),
                                    dict(iou_threshold=0.5, top_k=5),
                                    dict(iou_threshold=0.7, scores=True)])
def test_nms_matches_jax_and_returns_int64(kwargs):
    boxes = _boxes(40, 60, 60, 7)
    kw = dict(kwargs)
    if kw.pop("scores", None):
        kw["scores"] = np.random.default_rng(8).uniform(
            size=40).astype(np.float32)
    got = tpaddle.vision.ops.nms(tpaddle.to_tensor(boxes), **{
        k: tpaddle.to_tensor(v) if k == "scores" else v
        for k, v in kw.items()})
    want = jpaddle.vision.ops.nms(jpaddle.to_tensor(boxes), **{
        k: jpaddle.to_tensor(v) if k == "scores" else v
        for k, v in kw.items()})
    assert got.dtype == tpaddle.int64
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # a torch tensor in, a torch tensor out
    import torch
    raw = tpaddle.vision.ops.nms(torch.from_numpy(boxes), 0.3)
    assert isinstance(raw, torch.Tensor) and raw.dtype == torch.int64


@pytest.mark.parametrize("kwargs", [
    dict(min_sizes=[8.0], aspect_ratios=[2.0]),
    dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 30.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    dict(min_sizes=8.0, max_sizes=20.0, aspect_ratios=[2.0], flip=True,
         min_max_aspect_ratios_order=True, steps=(8.0, 8.0), offset=0.3),
])
def test_prior_box_matches_jax(kwargs):
    feat, img = np.zeros((1, 4, 5, 6), np.float32), \
        np.zeros((1, 3, 40, 48), np.float32)
    got = tpaddle.vision.ops.prior_box(tpaddle.to_tensor(feat),
                                       tpaddle.to_tensor(img), **kwargs)
    want = jpaddle.vision.ops.prior_box(jpaddle.to_tensor(feat),
                                        jpaddle.to_tensor(img), **kwargs)
    for g, w in zip(got, want):
        _close(g.numpy(), _np(w), "prior_box", 1e-6)


def test_distribute_fpn_proposals_matches_jax():
    rois = np.concatenate([_boxes(10, 100, 100, 2),
                           _boxes(6, 600, 600, 3)])
    got = tpaddle.vision.ops.distribute_fpn_proposals(
        tpaddle.to_tensor(rois), 2, 5, 4, 224)
    want = jpaddle.vision.ops.distribute_fpn_proposals(
        jpaddle.to_tensor(rois), 2, 5, 4, 224)
    assert len(got[0]) == len(want[0]) == 4
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_generate_proposals_matches_jax():
    a, h, w = 3, 6, 8
    r = np.random.default_rng(9)
    scores = r.uniform(size=(1, a, h, w)).astype(np.float32)
    deltas = (r.standard_normal((1, 4 * a, h, w)) * 0.2).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(h) * 16 + 8, np.arange(w) * 16 + 8,
                         indexing="ij")
    anchors = np.stack([np.stack([cx - s, cy - s, cx + s, cy + s], -1)
                        for s in (8, 16, 32)], 2).astype(np.float32)
    var = np.full((h, w, a, 4), 0.5, np.float32)
    im = np.asarray([[96, 128]], np.float32)
    kw = dict(pre_nms_top_n=100, post_nms_top_n=20, nms_thresh=0.6,
              min_size=2.0)
    got = tpaddle.vision.ops.generate_proposals(
        *[tpaddle.to_tensor(v) for v in (scores, deltas, im, anchors,
                                         var)], **kw)
    want = jpaddle.vision.ops.generate_proposals(
        *[jpaddle.to_tensor(v) for v in (scores, deltas, im, anchors,
                                         var)], **kw)
    assert len(got) == 3
    _close(got[0].numpy(), _np(want[0]), "rois", 1e-6)
    _close(got[1].numpy(), _np(want[1]), "scores", 1e-6)
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    assert len(tpaddle.vision.ops.generate_proposals(
        *[tpaddle.to_tensor(v) for v in (scores, deltas, im, anchors,
                                         var)], return_rois_num=False,
        **kw)) == 2


@pytest.mark.parametrize("kwargs", [
    dict(use_gaussian=False, return_index=True),
    dict(use_gaussian=True, gaussian_sigma=2.0, keep_top_k=10),
    dict(normalized=False, background_label=-1, return_rois_num=False),
])
def test_matrix_nms_matches_jax(kwargs):
    r = np.random.default_rng(12)
    boxes = np.stack([_boxes(30, 100, 100, s) / 100 for s in (13, 14)])
    scores = r.uniform(size=(2, 4, 30)).astype(np.float32)
    args = (0.2, 0.1, 20)
    kw = dict(kwargs)
    kw.setdefault("keep_top_k", 25)
    got = tpaddle.vision.ops.matrix_nms(
        tpaddle.to_tensor(boxes), tpaddle.to_tensor(scores), *args, **kw)
    want = jpaddle.vision.ops.matrix_nms(
        jpaddle.to_tensor(boxes), jpaddle.to_tensor(scores), *args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g.numpy(), _np(w), "matrix_nms", 1e-6)


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    img = (np.random.default_rng(5).uniform(size=(12, 10, 3)) * 255) \
        .astype(np.uint8)
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG")
    path = tmp_path / "x.jpg"
    path.write_bytes(buf.getvalue())
    got = tpaddle.vision.ops.read_file(str(path))
    want = jpaddle.vision.ops.read_file(str(path))
    assert got.dtype == tpaddle.uint8
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for mode in ("unchanged", "gray", "rgb"):
        g = tpaddle.vision.ops.decode_jpeg(got, mode=mode)
        w = jpaddle.vision.ops.decode_jpeg(want, mode=mode)
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_ops_surface_is_the_jax_surface():
    assert tpaddle.vision.ops.__all__ == jpaddle.vision.ops.__all__
    for name in tpaddle.vision.ops.__all__:
        assert callable(getattr(tpaddle.vision.ops, name)), name
    with pytest.raises(NotImplementedError):
        tpaddle.vision.ops.box_coder(None, None, None)
    with pytest.raises(NotImplementedError):
        tpaddle.vision.ops.deform_conv2d(
            tpaddle.to_tensor(_f(1, 4, 5, 5)),
            tpaddle.to_tensor(_f(1, 18, 5, 5)),
            tpaddle.to_tensor(_f(4, 2, 3, 3)), groups=2)
