"""The port's ``paddle.metric`` against the JAX package's, on the CPU:
``Accuracy`` (top-1 and top-k, labels with and without a trailing axis,
streamed over batches), ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy`` on the same seeded numpy inputs."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from test_torch_tensor import port_on_cpu  # noqa: F401


def _batches(n=3, rows=7, classes=6, label_axis=True):
    rng = np.random.default_rng(2)
    for _ in range(n):
        pred = rng.standard_normal((rows, classes)).astype(np.float32)
        lbl = rng.integers(0, classes, (rows, 1) if label_axis else (rows,))
        yield pred, lbl


@pytest.mark.parametrize("topk", [1, (1, 3)])
@pytest.mark.parametrize("label_axis", [True, False])
def test_accuracy_matches_jax(topk, label_axis):
    ms = [pkg.metric.Accuracy(topk=topk) for pkg in (tpaddle, jpaddle)]
    for pred, lbl in _batches(label_axis=label_axis):
        step = []
        for pkg, m in zip((tpaddle, jpaddle), ms):
            corr = m.compute(pkg.to_tensor(pred), pkg.to_tensor(lbl))
            step.append(m.update(corr))
        np.testing.assert_allclose(step[0], step[1], rtol=1e-6)
    np.testing.assert_allclose(ms[0].accumulate(), ms[1].accumulate(),
                               rtol=1e-6)
    assert ms[0].name() == ms[1].name() == "acc"
    ms[0].reset()
    assert ms[0].accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


def test_accuracy_over_sequences():
    """[B, L, V] logits against [B, L] labels (the LM head)."""
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((2, 5, 11)).astype(np.float32)
    lbl = rng.integers(0, 11, (2, 5))
    got = tpaddle.metric.Accuracy()
    want = jpaddle.metric.Accuracy()
    got.update(got.compute(tpaddle.to_tensor(pred), tpaddle.to_tensor(lbl)))
    want.update(want.compute(jpaddle.to_tensor(pred),
                             jpaddle.to_tensor(lbl)))
    assert got.accumulate() == pytest.approx(want.accumulate())
    assert got.count == want.count == [10]


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(cls):
    rng = np.random.default_rng(4)
    ms = [getattr(pkg.metric, cls)() for pkg in (tpaddle, jpaddle)]
    for _ in range(3):
        preds = rng.uniform(0, 1, (9, 1)).astype(np.float32)
        if cls == "Auc":
            preds = np.concatenate([1 - preds, preds], axis=1)
        labels = rng.integers(0, 2, (9, 1))
        for pkg, m in zip((tpaddle, jpaddle), ms):
            m.update(pkg.to_tensor(preds), pkg.to_tensor(labels))
    assert ms[0].accumulate() == pytest.approx(ms[1].accumulate())
    assert ms[0].name() == ms[1].name()
    ms[0].reset()
    assert ms[0].accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_matches_jax(k):
    pred, lbl = next(_batches())
    got = tpaddle.metric.accuracy(tpaddle.to_tensor(pred),
                                  tpaddle.to_tensor(lbl), k=k)
    want = jpaddle.metric.accuracy(jpaddle.to_tensor(pred),
                                   jpaddle.to_tensor(lbl), k=k)
    assert float(got) == pytest.approx(float(want))
