"""The port's LR schedulers against the JAX package's, on the CPU.

Every scheduler is pure Python with the JAX package's arithmetic, so
each ``get_lr()`` must be float-equal over 30 steps, and the state dicts
equal and interchangeable.
"""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import lr_state_from_jax
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30
# a scripted metric sequence for ReduceOnPlateau: falls, stalls, falls
METRICS = [5.0, 4.0, 3.9, 3.95, 3.96, 3.97, 3.98, 3.99, 3.5, 3.6, 3.6,
           3.6, 3.6, 3.6, 3.2, 3.3, 3.3, 3.3, 3.3, 3.3, 3.3, 3.3, 3.3, 3.0,
           3.1, 3.1, 3.1, 3.1, 3.1, 3.1]


def _cases():
    """(id, make(module) -> scheduler): each maker takes the lr
    module of one package, so both sides are built alike."""
    return [
        ("NoamDecay", lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                            learning_rate=2.0)),
        ("PiecewiseDecay", lambda m: m.PiecewiseDecay(
            boundaries=[3, 10, 20], values=[0.1, 0.05, 0.01, 0.001])),
        ("NaturalExpDecay", lambda m: m.NaturalExpDecay(0.5, gamma=0.1)),
        ("InverseTimeDecay", lambda m: m.InverseTimeDecay(0.5, gamma=0.3)),
        ("PolynomialDecay", lambda m: m.PolynomialDecay(
            0.1, decay_steps=12, end_lr=0.001, power=2.0)),
        ("PolynomialDecay-cycle", lambda m: m.PolynomialDecay(
            0.1, decay_steps=7, end_lr=0.001, power=1.5, cycle=True)),
        ("LinearWarmup-float", lambda m: m.LinearWarmup(
            0.1, warmup_steps=5, start_lr=0.0, end_lr=0.1)),
        ("LinearWarmup-cosine", lambda m: m.LinearWarmup(
            m.CosineAnnealingDecay(0.1, T_max=20), warmup_steps=6,
            start_lr=0.001, end_lr=0.1)),
        ("ExponentialDecay", lambda m: m.ExponentialDecay(0.2, gamma=0.9)),
        ("MultiStepDecay", lambda m: m.MultiStepDecay(
            0.3, milestones=[4, 9, 17], gamma=0.5)),
        ("StepDecay", lambda m: m.StepDecay(0.3, step_size=4, gamma=0.7)),
        ("LambdaDecay", lambda m: m.LambdaDecay(
            0.2, lr_lambda=lambda e: 0.95 ** e)),
        ("MultiplicativeDecay", lambda m: m.MultiplicativeDecay(
            0.2, lr_lambda=lambda e: 0.97)),
        ("CosineAnnealingDecay", lambda m: m.CosineAnnealingDecay(
            0.1, T_max=13, eta_min=0.001)),
        ("CosineAnnealingWarmRestarts", lambda m:
            m.CosineAnnealingWarmRestarts(0.1, T_0=4, T_mult=2,
                                          eta_min=0.0005)),
        ("ReduceOnPlateau", lambda m: m.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, cooldown=1, min_lr=0.001)),
        ("OneCycleLR-cos", lambda m: m.OneCycleLR(
            0.1, total_steps=25, phase_pct=0.3)),
        ("OneCycleLR-linear", lambda m: m.OneCycleLR(
            0.1, total_steps=25, anneal_strategy="linear")),
        ("CyclicLR-triangular2", lambda m: m.CyclicLR(
            0.01, 0.1, step_size_up=4, step_size_down=3,
            mode="triangular2")),
        ("CyclicLR-exp_range", lambda m: m.CyclicLR(
            0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97)),
    ]


CASES = _cases()


def _advance(sched, steps, start=0):
    lrs = []
    for s in range(start, start + steps):
        lrs.append(sched())
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(METRICS[s % len(METRICS)])
        else:
            sched.step()
    return lrs


def test_every_scheduler_is_covered():
    names = {c for c in dir(jlr) if isinstance(getattr(jlr, c), type)
             and issubclass(getattr(jlr, c), jlr.LRScheduler)
             and c != "LRScheduler"}
    ported = {c for c in dir(tlr) if isinstance(getattr(tlr, c), type)
              and issubclass(getattr(tlr, c), tlr.LRScheduler)
              and c != "LRScheduler"}
    assert names == ported
    assert names == {case_id.split("-")[0] for case_id, _ in CASES}


@pytest.mark.parametrize("build", [b for _, b in CASES],
                         ids=[i for i, _ in CASES])
def test_scheduler_is_float_equal_to_jax(build):
    want = _advance(build(jlr), STEPS)
    got = _advance(build(tlr), STEPS)
    assert got == want
    assert all(isinstance(x, float) and math.isfinite(x) for x in got)


@pytest.mark.parametrize("build", [b for _, b in CASES],
                         ids=[i for i, _ in CASES])
def test_state_dict_round_trips_with_jax(build):
    """After 7 steps the two state dicts are equal; a fresh port
    scheduler loaded with the JAX dict continues float-equal to a fresh
    JAX scheduler loaded with it, and so does a port scheduler loaded
    with its own dict. (The dicts hold the public attributes only, in
    both packages: MultiplicativeDecay's running ``_cur`` and
    ReduceOnPlateau's ``_lr`` do not come across, so there the loaded
    schedulers restart from the base lr.)"""
    j, t = build(jlr), build(tlr)
    _advance(j, 7)
    _advance(t, 7)
    jsd, tsd = j.state_dict(), t.state_dict()
    assert tsd == jsd
    j2, t2, t3 = build(jlr), build(tlr), build(tlr)
    j2.set_state_dict(jsd)
    t2.set_state_dict(lr_state_from_jax(jsd))
    t3.set_state_dict(tsd)
    want = _advance(j2, 10, 7)
    assert _advance(t2, 10, 7) == want
    assert _advance(t3, 10, 7) == want
    if not isinstance(j, (jlr.MultiplicativeDecay, jlr.ReduceOnPlateau)):
        assert want == _advance(j, 10, 7)
