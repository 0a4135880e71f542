"""hapi callbacks of the port: ``Callback``, ``CallbackList``,
``History``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping``, ``MetricsLogger``, ``VisualDL`` and
``config_callbacks``.

The port's copy of ``paddle_tpu/hapi/callbacks.py`` (pure Python):
the same hooks in the same order, so a ``Model.fit`` on either package
calls a callback the same way. A loss in the batch logs is a lazy
device Tensor: ``ProgBarLogger`` (at its ``log_freq``),
``MetricsLogger`` and ``VisualDL`` read it on the host, which waits for
the step, so a run that must not wait for the device per step (the
captured steps of ``Model.fit``) uses ``verbose=0`` and no per-batch
logger. ``MetricsLogger`` drives ``observability.timeline.StepTimer``
(host wall time of each batch).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "VisualDL", "History", "MetricsLogger",
           "CallbackList", "config_callbacks"]


class Callback:
    """Every hook is a no-op by default."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)


class History(Callback):
    """Collects per-epoch logs; ``fit`` installs one."""

    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgBarLogger(Callback):
    """Prints per-epoch logs and, with ``verbose > 1``, every
    ``log_freq``-th batch's, one line each."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {_fmt(v)}"
                               for k, v in (logs or {}).items())
            print(f"step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {_fmt(v)}"
                               for k, v in (logs or {}).items())
            print(f"epoch {epoch + 1} done in "
                  f"{time.time() - self._t0:.1f}s - {items}")


def _fmt(v):
    try:
        arr = np.asarray(v, dtype=np.float64)
        if arr.size == 1:
            return f"{float(arr):.4f}"
        return np.array2string(arr, precision=4)
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    """Saves the model every ``save_freq`` epochs (``save_dir/<epoch>``)
    and at the end of training (``save_dir/final``)."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's ``LRScheduler`` every epoch, or every batch
    with ``by_step``."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Watches an eval metric and stops training after ``patience``
    evals without improvement, restoring the best weights when
    ``save_best_model``."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0,
                 baseline=None, save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))
        self.best_weights = None
        self._epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def _improved(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self._improved(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.model is not None:
                # copies: the port's parameters update in place
                self.best_weights = {
                    k: np.array(v.numpy(), copy=True)
                    for k, v in self.model.network.state_dict().items()}
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                self.stopped_epoch = self._epoch
                if self.verbose:
                    print(f"early stopping: {self.monitor} did not "
                          f"improve past {self.best:.5f} for "
                          f"{self.patience} evals")
                if self.best_weights is not None:
                    self.model.network.set_state_dict(self.best_weights)


class MetricsLogger(Callback):
    """Telemetry for ``Model.fit``: drives an
    ``observability.timeline.StepTimer`` through the batch boundaries
    (each batch's host wall time in ``step.step_seconds`` and as a
    chrome counter event kept by the timer) and mirrors batch and epoch
    logs into registry gauges (``train.<metric>`` / ``eval.<metric>``),
    so one ``observability.metrics.snapshot()`` after ``fit`` carries
    the loss curve beside the other counters. ``log_freq > 0`` also
    prints a one-line digest every N batches (the step seconds and the
    captured steps, ``sot.captured_steps_total``)."""

    def __init__(self, log_freq: int = 0, timer_name: str = "hapi"):
        super().__init__()
        self.log_freq = int(log_freq)
        self.timer_name = timer_name
        self.timer = None

    def _gauges(self):
        from ..observability import metrics as om
        return om

    def on_train_begin(self, logs=None):
        from ..observability.timeline import StepTimer
        if self.timer is None:
            self.timer = StepTimer(self.timer_name)
        self._phase_cm = None

    def on_train_batch_begin(self, step, logs=None):
        if self.timer is None:
            return
        self._phase_cm = self.timer.phase("step")
        self._phase_cm.__enter__()

    def on_train_batch_end(self, step, logs=None):
        if self.timer is None:
            return
        if self._phase_cm is not None:
            self._phase_cm.__exit__(None, None, None)
            self._phase_cm = None
        phases = self.timer.step()
        om = self._gauges()
        for k, v in (logs or {}).items():
            try:
                om.gauge(f"train.{k}").set(
                    float(np.asarray(v).reshape(-1)[0]))
            except (TypeError, ValueError):
                continue
        if self.log_freq > 0 and step % self.log_freq == 0:
            snap = om.snapshot()
            captured = snap.get("sot", {}).get("captured_steps_total", 0)
            print(f"[metrics] step {step}: "
                  f"step_s={phases.get('step', 0.0):.4f} "
                  f"captured_steps={captured}")

    def on_eval_end(self, logs=None):
        om = self._gauges()
        for k, v in (logs or {}).items():
            try:
                om.gauge(f"eval.{k}").set(
                    float(np.asarray(v).reshape(-1)[0]))
            except (TypeError, ValueError):
                continue


class VisualDL(Callback):
    """Scalar logger: the tag / step / value triples a VisualDL writer
    records, appended to ``log_dir/scalars.jsonl``. Records buffer in
    memory and flush at epoch and eval end and at train end, so a
    batch writes no file."""

    def __init__(self, log_dir: str = "vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0
        self._buf = []

    def _record(self, tag, value, step):
        try:
            self._buf.append({"tag": tag, "step": step,
                              "value": float(np.asarray(value)
                                             .reshape(-1)[0])})
        except (TypeError, ValueError):
            pass

    def _flush(self):
        if not self._buf:
            return
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            for rec in self._buf:
                f.write(json.dumps(rec) + "\n")
        self._buf.clear()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            self._record(f"train/{k}", v, self._step)

    def on_epoch_end(self, epoch, logs=None):
        self._flush()

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            self._record(f"eval/{k}", v, self._step)
        self._flush()

    def on_train_end(self, logs=None):
        self._flush()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, save_freq=1, save_dir=None, metrics=None,
                     log_freq=1, mode="train"):
    """The default callback set around ``callbacks``: a ProgBarLogger
    (when ``verbose``), a ModelCheckpoint (when ``save_dir``), an
    LRScheduler and a History, all given the model and the params."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq=log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    history = next((c for c in cbks if isinstance(c, History)), None)
    if history is None:
        history = History()
        cbks.append(history)
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst, history
