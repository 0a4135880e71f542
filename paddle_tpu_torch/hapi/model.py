"""The high-level Model API of the port: ``Model``, ``summary``, ``flops``.

The port of ``paddle_tpu/hapi/model.py``. ``Model(network).prepare(
optimizer, loss, metrics, amp_configs)`` then ``fit`` / ``evaluate`` /
``predict``, ``train_batch`` / ``eval_batch`` / ``predict_batch``,
``save`` / ``load`` (``framework.io``, the JAX package's file format:
each package loads the other's ``.pdparams`` / ``.pdopt``) and
``summary`` / ``flops`` by forward hooks.

``train_batch`` and ``eval_batch`` run through ``jit.sot.CapturedStep``:
a signature's first batch runs the eager step, the second captures the
whole step (forward, loss, backward, clip and optimizer update, under
the AMP regime of ``amp_configs``, with the GradScaler's iteration when
one is configured) into one CUDA graph, later batches replay it. The
loss comes back as a lazy device Tensor; ``fit`` reads the epoch's
losses on the host once, at the epoch's end (one transfer).
``FLAGS_sot_capture=0`` runs every step eager.

``prepare(warm_bundle=...)`` (a manifest path or a loaded dict;
default ``FLAGS_warmup_bundle``) pre-warms the captured steps a bundle
recorded (``jit.warmup.prewarm``): each signature's first sighting and
its capture run at ``prepare``, on zero batches, and the model, the
optimizer, the GradScaler and the key streams are put back after, so
the first ``train_batch`` of a recorded signature is a graph replay.
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import numpy as np
import torch

from ..core.tensor import Tensor
from .callbacks import config_callbacks

__all__ = ["Model", "summary", "flops"]

def _to_tensor(x):
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor(x)
    from ..core.tensor import to_tensor
    return to_tensor(np.asarray(x))


def _mean_loss(losses):
    """Mean of a list of lazy 0-d loss Tensors (or floats) with one
    device-to-host transfer."""
    vals = [v._t.detach().float().reshape(()) if isinstance(v, Tensor)
            else torch.tensor(float(v)) for v in losses]
    dev = next((v.device for v in vals if v.device.type != "cpu"), None)
    if dev is not None:
        vals = [v.to(dev) for v in vals]
    return float(torch.stack(vals).cpu().double().mean())


def _as_batches(data, batch_size, shuffle, drop_last=False):
    """A DataLoader, a Dataset or an ``(inputs, labels)`` pair of arrays
    as an iterable of ``(inputs, labels)`` batches."""
    from ..io import DataLoader, Dataset
    if isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size or 1,
                          shuffle=shuffle, drop_last=drop_last)
    if isinstance(data, (tuple, list)) and len(data) == 2:
        x, y = data
        n = len(x)
        bs = batch_size or n

        def gen():
            order = np.random.permutation(n) if shuffle else np.arange(n)
            stop = (n - n % bs) if drop_last else n
            for i in range(0, stop, bs):
                sel = order[i:i + bs]
                yield (x[sel], y[sel])
        return gen()
    raise TypeError(f"unsupported data type {type(data)!r}: pass a "
                    f"DataLoader, a Dataset or an (inputs, labels) pair")


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


class Model:
    """Train, evaluate and predict over a Layer."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List = []
        self._captured = None  # the whole-step capture engine (lazy)
        self._amp = None       # auto_cast kwargs (amp_configs)
        self._scaler = None    # the GradScaler of an AMP step
        self.stop_training = False

    # -- configuration -------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, warm_bundle=None):
        """``amp_configs``: a level string ("O1", "O2", "O0") or a dict
        of ``level`` / ``dtype`` / ``custom_white_list`` /
        ``custom_black_list`` and the GradScaler's knobs
        (``init_loss_scaling``, ``incr_ratio``, ``decr_ratio``,
        ``incr_every_n_steps``, ``decr_every_n_nan_or_inf``,
        ``use_dynamic_loss_scaling``) or a ``scaler``; the forward and
        loss then run under ``amp.auto_cast``, and backward and update
        through the GradScaler when there is one (f16 always makes
        one). ``warm_bundle``: see the module docstring."""
        self._optimizer = optimizer
        self._loss = loss
        ms = metrics or []
        self._metrics = list(ms) if isinstance(ms, (list, tuple)) else [ms]
        self._captured = None  # a new loss or optimizer: old graphs out
        self._amp, self._scaler = self._parse_amp(amp_configs)
        from ..core.flags import flag_value
        bundle = warm_bundle if warm_bundle is not None \
            else (flag_value("warmup_bundle") or None)
        if bundle:
            from ..jit import warmup
            warmup.prewarm(bundle, captured=self._capture_engine())
        return self

    @staticmethod
    def _parse_amp(amp_configs):
        if not amp_configs:
            return None, None
        if isinstance(amp_configs, str):
            amp_configs = {"level": amp_configs}
        cfg = dict(amp_configs)
        level = str(cfg.pop("level", "O1")).upper()
        if level == "O0":
            return None, None
        scaler = cfg.pop("scaler", None)
        scaler_keys = {
            "init_loss_scaling", "incr_ratio", "decr_ratio",
            "incr_every_n_steps", "decr_every_n_nan_or_inf",
            "use_dynamic_loss_scaling"}
        scaler_kw = {k: cfg.pop(k) for k in list(cfg) if k in scaler_keys}
        amp = {"level": level,
               "dtype": cfg.pop("dtype", "bfloat16"),
               "custom_white_list": cfg.pop("custom_white_list", None),
               "custom_black_list": cfg.pop("custom_black_list", None)}
        cfg.pop("use_fp16_guard", None)  # accepted, as paddle takes it
        if cfg:
            raise ValueError(f"unknown amp_configs keys: {sorted(cfg)}")
        if scaler is not None and scaler_kw:
            raise ValueError(
                f"amp_configs passes both an explicit scaler and "
                f"scaler knobs {sorted(scaler_kw)} — configure the "
                f"scaler you pass, or drop it and pass the knobs")
        if scaler is None and (scaler_kw
                               or str(amp["dtype"]) == "float16"):
            # f16 needs loss scaling; bf16 gets a scaler only when
            # scaler knobs ask for one
            from ..amp import GradScaler
            from ..core.device import current_device
            scaler = GradScaler(**scaler_kw, device=current_device())
        return amp, scaler

    def _amp_ctx(self):
        if self._amp is None:
            return contextlib.nullcontext()
        from ..amp.auto_cast import auto_cast
        return auto_cast(True, **self._amp)

    def _capture_engine(self):
        """The whole-step capture engine behind train_batch and
        eval_batch (``jit.sot.CapturedStep``)."""
        if self._captured is None:
            from ..jit.sot import CapturedStep
            self._captured = CapturedStep(
                self.network, self._loss, self._optimizer,
                mean_reduce=True, name="hapi.step")
            self._captured.step_runner = self._prewarm_step
            self._captured.scaler = self._scaler \
                if self._amp is not None else None
        return self._captured

    def _prewarm_step(self, kind, ins, lbls):
        """A prewarm's step (``CapturedStep.step_runner``): the batch through
        this model's own train or eval step (no metric updated)."""
        if kind == "eval":
            self.network.eval()
            self._eval_step(ins, lbls)
        else:
            self.train_batch(ins, lbls)

    def _loss_of(self, out, lbl):
        loss = out
        if self._loss is not None:
            loss = self._loss(out, *lbl)
        if loss.ndim > 0:
            loss = loss.mean()
        return loss

    # -- single-batch ops ----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One forward, backward and (with ``update``) optimizer step.
        Returns ``[loss]``, a lazy 0-d device Tensor (``float(loss)``
        reads it)."""
        self.network.train()
        ins = [_to_tensor(i) for i in _as_list(inputs)]
        lbl = [_to_tensor(v) for v in _as_list(labels) if v is not None]
        scaler = self._scaler if self._amp is not None else None
        engine = None
        if update and self._optimizer is not None:
            engine = self._capture_engine()
            with self._amp_ctx():
                loss = engine.step(ins, lbl, scaler=scaler)
            if loss is not None:
                return [loss]
        with self._amp_ctx():
            loss = self._loss_of(self.network(*ins), lbl)
        if scaler is not None and scaler.is_enable():
            scaler.scale(loss).backward()
            if update and self._optimizer is not None:
                scaler.step(self._optimizer)
                scaler.update()
                self._optimizer.clear_grad()
        else:
            loss.backward()
            if update and self._optimizer is not None:
                self._optimizer.step()
                self._optimizer.clear_grad()
        if engine is not None:
            engine.eager_done()
        # detached: a loss that kept its graph would keep the leaves'
        # gradient accumulators alive, on this stream, into a capture
        return [loss.detach()]

    def eval_batch(self, inputs, labels=None):
        """One eval forward; ``outs['loss']`` is a lazy device Tensor;
        the metrics are updated with this batch."""
        self.network.eval()
        ins = [_to_tensor(i) for i in _as_list(inputs)]
        lbl = [_to_tensor(v) for v in _as_list(labels) if v is not None]
        out, loss = self._eval_step(ins, lbl)
        outs = {}
        if loss is not None:
            outs["loss"] = loss
        if labels is not None:
            for m in self._metrics:
                m.update(m.compute(out, lbl[0]))
        return outs

    def _eval_step(self, ins, lbl):
        """One eval forward (and loss, with labels): ``(out, loss)``."""
        out = loss = None
        engine = self._capture_engine()
        with self._amp_ctx():
            res = engine.forward(ins, lbl)
            if res is not None:
                out, loss = res
            else:
                with torch.no_grad():
                    out = self.network(*ins)
                    if self._loss is not None and lbl:
                        loss = self._loss_of(out, lbl)
                engine.eager_done()
        return out, loss

    def predict_batch(self, inputs):
        self.network.eval()
        ins = [_to_tensor(i) for i in _as_list(inputs)]
        with torch.no_grad():
            out = self.network(*ins)
        return out.numpy() if isinstance(out, Tensor) else out

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1,
            epochs=1, eval_freq=1, log_freq=10, save_dir=None,
            save_freq=1, verbose=2, drop_last=False, shuffle=True,
            num_workers=0, callbacks=None):
        """Train for ``epochs`` over ``train_data`` (evaluating on
        ``eval_data`` every ``eval_freq`` epochs). Returns the History
        dict: the per-epoch mean ``loss`` and ``eval_*`` logs."""
        cbks, history = config_callbacks(
            callbacks, model=self, epochs=epochs, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir, log_freq=log_freq,
            metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        logs = {}
        cbks.on_train_begin()
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            losses = []
            for step, (ins, lbl) in enumerate(
                    _as_batches(train_data, batch_size, shuffle,
                                drop_last)):
                cbks.on_train_batch_begin(step)
                loss = self.train_batch(ins, lbl)
                losses.append(loss[0])  # lazy device scalars
                cbks.on_train_batch_end(step, {"loss": loss[0]})
            # the log boundary: one fetch an epoch, not one a step
            logs = {"loss": _mean_loss(losses) if losses else None}
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, _callbacks=cbks)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return history.history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None):
        cbks = _callbacks
        if cbks is None:
            cbks, _ = config_callbacks(callbacks, model=self,
                                       verbose=verbose)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, (ins, lbl) in enumerate(
                _as_batches(eval_data, batch_size, False)):
            cbks.on_eval_batch_begin(step)
            outs = self.eval_batch(ins, lbl)
            if "loss" in outs:
                losses.append(outs["loss"])  # lazy device scalars
            cbks.on_eval_batch_end(step, outs)
        logs = {}
        if losses:
            logs["loss"] = _mean_loss(losses)
        for m in self._metrics:
            nm = m.name()
            logs[nm[0] if isinstance(nm, (list, tuple)) else nm] = \
                m.accumulate()
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        outs = []
        for batch in _as_batches(test_data, batch_size, False):
            ins = batch[0] if isinstance(batch, (tuple, list)) and \
                len(batch) == 2 else batch
            outs.append(self.predict_batch(ins))
        if stack_outputs and outs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    # -- persistence ---------------------------------------------------------
    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return None if p is None else p._t.device

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save as _save
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Install ``path.pdparams`` (and ``path.pdopt`` unless
        ``reset_optimizer``) of either package. Captured graphs are
        dropped: the optimizer's state tensors are new."""
        from ..framework.io import load as _load
        dev = self._device()
        self.network.set_state_dict(_load(path + ".pdparams", device=dev))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt",
                                                 device=dev))
        self._captured = None

    # -- introspection -------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)


# --------------------------- summary / flops --------------------------------

def _probe_inputs(input_size, dtypes, device):
    sizes = input_size if isinstance(input_size[0], (list, tuple)) \
        else [input_size]
    dts = dtypes if isinstance(dtypes, (list, tuple)) else \
        [dtypes or "float32"] * len(sizes)
    from ..core.dtype import convert_dtype
    return [Tensor(torch.zeros([d if isinstance(d, int) and d > 0 else 1
                                for d in s], dtype=convert_dtype(dt),
                               device=device))
            for s, dt in zip(sizes, dts)]


def _net_device(net):
    p = next(iter(net.parameters()), None)
    if p is not None:
        return p._t.device
    from ..core.device import current_device
    return current_device()


def _own_params(layer):
    return sum(int(np.prod(p.shape))
               for p in layer._parameters.values() if p is not None)


def _probe(net, fn):
    """Run ``fn`` in eval mode without gradients, the mode restored."""
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            fn()
    finally:
        if was_training:
            net.train()


def summary(net, input_size=None, dtypes=None, input=None):
    """A per-layer table of output shapes and own-parameter counts
    (printed) from one probe forward; returns ``{'total_params',
    'trainable_params'}``."""
    rows = []
    hooks = []

    def make_hook(name, layer):
        def hook(lyr, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            rows.append((name, layer.__class__.__name__,
                         list(getattr(out, "shape", [])),
                         _own_params(layer)))
        return hook

    for name, sub in net.named_sublayers():
        hooks.append(sub.register_forward_post_hook(make_hook(name, sub)))
    try:
        if input is not None:
            _probe(net, lambda: net(input))
        else:
            if input_size is None:
                raise ValueError("summary needs input_size or input")
            xs = _probe_inputs(input_size, dtypes, _net_device(net))
            _probe(net, lambda: net(*xs))
    finally:
        for h in hooks:
            h.remove()
    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)
    lines = [f"{'Layer':<36}{'Type':<24}{'Output Shape':<22}"
             f"{'Params':>10}", "-" * 92]
    for nm, ty, shape, n in rows:
        lines.append(f"{nm:<36}{ty:<24}{str(shape):<22}{n:>10}")
    lines += ["-" * 92, f"Total params: {total}",
              f"Trainable params: {trainable}"]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Multiply-adds of one forward at ``input_size`` (f32 zeros), by
    forward hooks: Linear ``out x in``, Conv ``out x prod(weight[1:])``,
    norms ``2 x out``, pools ``out``, and ``custom_ops[type](layer,
    inputs, outputs)``."""
    from .. import nn

    total = {"n": 0}
    hooks = []

    def count_for(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        oshape = list(getattr(out, "shape", []))
        n = 0
        if custom_ops and type(layer) in custom_ops:
            n = custom_ops[type(layer)](layer, inputs, outputs)
        elif isinstance(layer, nn.Linear):
            n = int(np.prod(oshape)) * int(layer.weight.shape[0])
        elif layer.__class__.__name__.startswith("Conv"):
            n = int(np.prod(oshape)) * int(np.prod(layer.weight.shape[1:]))
        elif "Norm" in layer.__class__.__name__:
            n = int(np.prod(oshape)) * 2
        elif "Pool" in layer.__class__.__name__:
            n = int(np.prod(oshape))
        total["n"] += n

    for _, sub in net.named_sublayers(include_self=True):
        hooks.append(sub.register_forward_post_hook(count_for))
    xs = _probe_inputs(input_size, None, _net_device(net))
    try:
        _probe(net, lambda: net(*xs))
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"FLOPs (multiply-adds): {total['n']}")
    return total["n"]
