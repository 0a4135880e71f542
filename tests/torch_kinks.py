"""The linear pieces that piecewise-linear activations take, recorded in
one run and followed in another.

An activation input within rounding of a ReLU's or ReLU6's kink can
fall on one piece in one run and on the other in a run of another
precision or summation order. In a network with batch norms one such
element, out of millions, moves some gradients by several per cent, so
a comparison of two runs' gradients compares their pieces as well as
their rounding. Tests that compare gradients record the pieces of the
JAX package's run from inside its compiled program
(:func:`record_jax_slopes`) and make each port run differentiate with
those slopes where its own differ (:func:`follow_slopes`): its forward
values and every other element's backward stay its own, and the number
of elements that differed is counted, so a test can hold it to
``MAX_FLIPS`` (a wrong activation or a wrong input flips thousands).
"""
import numpy as np

MAX_FLIPS = 8

KINKED = {"ReLU": lambda x: x > 0,
          "ReLU6": lambda x: (x > 0) & (x < 6)}


def _kinked(model):
    return [m for m in model.sublayers() if type(m).__name__ in KINKED]


def _torch(t):
    return getattr(t, "_t", t)


def record_jax_slopes(model):
    """(slopes, hooks) for a JAX package model: each kinked activation
    reports its slopes through an ordered ``jax.debug.callback``, so a
    jitted or captured program reports the pieces it computed."""
    import jax

    slopes = []

    def hook(m, inputs, out):
        x = inputs[0]._data
        jax.debug.callback(lambda s: slopes.append(np.asarray(s)),
                           KINKED[type(m).__name__](x), ordered=True)
    return slopes, [m.register_forward_post_hook(hook)
                    for m in _kinked(model)]


def follow_slopes(model, slopes, flips):
    """Make ``model``'s kinked activations differentiate with ``slopes``
    (consumed in call order) where their own differ, and append the
    count of such elements of each call to ``flips``. The layers'
    ``forward`` is wrapped, not hooked, so a ``TrainStep`` takes the
    path it takes without it. Returns the function that unwraps them."""
    import torch

    it = iter(slopes)
    layers = _kinked(model)

    def wrap(m, base):
        def forward(x, *args, **kwargs):
            o = base(x, *args, **kwargs)
            xt, out = _torch(x), _torch(o)
            want = torch.as_tensor(np.asarray(next(it)), device=xt.device)
            own = KINKED[type(m).__name__](xt.detach())
            flips.append(int((want != own).sum()))
            diff = want.to(out.dtype) - own.to(out.dtype)
            res = out + diff * (xt - xt.detach())
            return res if out is o else type(o)(res)
        return forward

    for m in layers:
        m.forward = wrap(m, m.forward)

    def unwrap():
        for m in layers:
            del m.forward
    return unwrap
