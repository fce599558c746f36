"""The port's timm-style schedulers (youku_mplug_tpu_torch.optim.schedulers)
against the JAX package's (youku_mplug_tpu.optim.schedulers), value for
value: cosine with warmup, restarts (t_mul), cycle decay and cycle limit,
tanh, step, plateau (both modes, patience, cooldown), lr noise of both
types over a range and from a start, and every create_scheduler branch.
Both are host-side Python: equality is exact."""

import types

import pytest

from youku_mplug_tpu.optim import schedulers as js
from youku_mplug_tpu_torch.optim import schedulers as ts

NOISE = dict(noise_range_t=(3, 9), noise_pct=0.5, noise_std=1.0,
             noise_seed=7)


def _values(sched, ts_range):
    return [sched(t) for t in ts_range]


@pytest.mark.parametrize("kind,kw", [
    ("cosine", dict(base_lr=0.1, t_initial=10)),
    ("cosine", dict(base_lr=0.1, t_initial=5, t_mul=2.0, lr_min=1e-3,
                    decay_rate=0.5, warmup_t=3, warmup_lr_init=1e-4,
                    cycle_limit=3)),
    ("cosine", dict(base_lr=0.1, t_initial=4, warmup_t=2,
                    warmup_prefix=False, cycle_limit=2, **NOISE)),
    ("tanh", dict(base_lr=0.1, t_initial=10)),
    ("tanh", dict(base_lr=0.1, t_initial=6, t_mul=1.5, lr_min=1e-3,
                  decay_rate=0.7, warmup_t=2, warmup_lr_init=1e-3,
                  cycle_limit=2, **NOISE)),
    ("tanh", dict(base_lr=0.1, t_initial=6, warmup_t=2, warmup_prefix=True,
                  noise_range_t=4, noise_type="uniform")),
    ("step", dict(base_lr=0.1, decay_t=3, decay_rate=0.5)),
    ("step", dict(base_lr=0.1, decay_t=2.5, decay_rate=0.3, warmup_t=2,
                  warmup_lr_init=1e-3, **NOISE)),
])
def test_schedulers_match_jax(kind, kw):
    cls = {"cosine": "CosineLRScheduler", "tanh": "TanhLRScheduler",
           "step": "StepLRScheduler"}[kind]
    want = getattr(js, cls)(**kw)
    got = getattr(ts, cls)(**kw)
    ts_range = [i * 0.5 for i in range(60)]
    assert _values(got, ts_range) == _values(want, ts_range)
    if kind == "cosine":
        for cycles in (0, 1, 3):
            assert got.get_cycle_length(cycles) == \
                want.get_cycle_length(cycles)


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, decay_rate=0.5, patience_t=1, mode="max"),
    dict(base_lr=0.1, decay_rate=0.5, patience_t=0, cooldown_t=2,
         mode="min", lr_min=0.01, warmup_t=2, warmup_lr_init=1e-3,
         **NOISE),
])
def test_plateau_matches_jax(kw):
    want, got = js.PlateauLRScheduler(**kw), ts.PlateauLRScheduler(**kw)
    metrics = [0.5, 0.6, 0.6, 0.59, 0.58, 0.7, 0.7, 0.69, 0.4, 0.4, None,
               0.3, 0.3, 0.3]
    assert [got.step(e, m) for e, m in enumerate(metrics)] == \
        [want.step(e, m) for e, m in enumerate(metrics)]


def _args(sched, **kw):
    base = dict(sched=sched, epochs=20, lr=0.05, min_lr=1e-5,
                decay_rate=0.5, warmup_lr=1e-4, warmup_epochs=2,
                decay_epochs=4, patience_epochs=2, num_iterations=100,
                seed=3)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("args", [
    _args("cosine"),
    _args("cosine", lr_cycle_mul=2.0, lr_cycle_limit=2, cooldown_epochs=3,
          lr_noise=[0.2, 0.6], lr_noise_pct=0.4),
    _args("cosine_step", lr_noise=0.5),
    _args("tanh", lr_cycle_limit=1, lr_noise=[0.5]),
    _args("step", lr_noise=[0.1, 0.9], lr_noise_std=2.0),
    _args("plateau", eval_metric="loss"),
    _args("plateau", eval_metric="top1"),
])
def test_create_scheduler_matches_jax(args):
    want, want_epochs = js.create_scheduler(args)
    got, got_epochs = ts.create_scheduler(args)
    assert type(got).__name__ == type(want).__name__
    assert got_epochs == want_epochs
    if args.sched == "plateau":
        assert got.mode == want.mode
        seq = [got.step(e, 1.0 / (e + 1)) for e in range(12)]
        assert seq == [want.step(e, 1.0 / (e + 1)) for e in range(12)]
    else:
        assert _values(got, range(40)) == _values(want, range(40))


def test_unknown_sched_raises_as_in_jax():
    for mod in (js, ts):
        with pytest.raises(ValueError, match="unknown sched"):
            mod.create_scheduler(_args("poly"))
