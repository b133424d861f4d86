"""Faults planted in the timed path, and the control, for the checks that
show the comparison fails them (``calibrate.py`` on the card, the tests on
the CPU).  Each is a context manager over the program's own functions:

* ``state_unchanged`` — every outer round returns the orders it was given
  (the commit of the permutation left out);
* ``state_unchanged_from_2`` — the same from round 2 on: a driver that
  stops committing once rounds 0 and 1, which the reference follows, are
  past;
* ``state_unchanged_late`` — the same from round R/4 on, the second of
  the server's four rungs: a request's state lost between rungs;
* ``half_batch`` — the loss of the second half of a batch's instances is
  left out and replaced by the mean over the first half (their keys get no
  gradient);
* ``answer_altered`` — each round's committed order of instance 0 has its
  first cell overwritten with its second's;
* ``control`` — not a fault: the program's own bfloat16 kernel tier,
  the precision below the configuration's float32 (set on the config).
"""
from __future__ import annotations

import contextlib

import torch

CONTROL = "control"


@contextlib.contextmanager
def _patched(name: str, wrap):
    from repro_torch.core import shufflesoftsort as sss
    orig = getattr(sss, name)
    setattr(sss, name, wrap(orig))
    try:
        yield
    finally:
        setattr(sss, name, orig)


def state_unchanged(from_round: int = 0):
    """Rows whose round (found from their temperatures, the schedule's
    own) is ``from_round`` or later keep the orders they were given."""
    from repro_torch.core import shufflesoftsort as sss

    def wrap(orig):
        def outer(xs, orders, shuf, tau_inner, *a, **k):
            new, loss, w = orig(xs, orders, shuf, tau_inner, *a, **k)
            taus = torch.as_tensor(sss._inner_taus(k["cfg"])[:, 0],
                                   device=tau_inner.device)
            r = torch.argmin((tau_inner[:, :1] - taus).abs(), dim=1)
            keep = (r >= from_round).expand(orders.shape[0])[:, None]
            return torch.where(keep, orders, new), loss, w
        return outer
    return _patched("_outer_round", wrap)


def half_batch():
    def wrap(orig):
        def loss_fn(w, x_shuf, inv_shuf, tau, hw, norm, *a, **k):
            h = max(1, w.shape[0] // 2)
            if h == w.shape[0]:
                return orig(w, x_shuf, inv_shuf, tau, hw, norm, *a, **k)
            tau_h = tau[:h] if tau.numel() > 1 else tau
            kept = orig(w[:h], x_shuf[:h], inv_shuf[:h], tau_h, hw,
                        norm[:h], *a, **k)
            rest = kept.mean().expand(w.shape[0] - h) + 0 * w[h:].sum(-1)
            return torch.cat([kept, rest])
        return loss_fn
    return _patched("_loss_fn", wrap)


def answer_altered():
    def wrap(orig):
        def outer(*a, **k):
            o, loss, w = orig(*a, **k)
            o = o.clone()
            o[0, 0] = o[0, 1]
            return o, loss, w
        return outer
    return _patched("_outer_round", wrap)


# Each fault's context from the configuration's number of rounds.
FAULTS = {"state_unchanged": lambda rounds: state_unchanged(0),
          "state_unchanged_from_2": lambda rounds: state_unchanged(2),
          "state_unchanged_late": lambda rounds: state_unchanged(
              max(1, rounds // 4)),
          "half_batch": lambda rounds: half_batch(),
          "answer_altered": lambda rounds: answer_altered()}


def variant(spec: dict, name: str):
    """(spec, context) of a run of ``name``: "sound", ``CONTROL`` or a
    fault of ``FAULTS``."""
    if name == "sound":
        return spec, contextlib.nullcontext()
    if name == CONTROL:
        config = dict(spec["config"])
        config["program"] = dict(config["program"], compute_dtype="bfloat16")
        return dict(spec, config=config), contextlib.nullcontext()
    return spec, FAULTS[name](spec["config"]["cfg"]["rounds"])
