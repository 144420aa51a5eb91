"""Faults planted underneath the timed path, to show that the comparison
catches them (the tests, and ``calibrate.py`` on the card):

* ``unchanged``: the step computes its loss and gradients and returns its
  state unchanged;
* ``half``: the step sees half of its batch, the mean taken over the rest.
"""

from __future__ import annotations


def unchanged(job):
    job.update = lambda params, grads, state, cfg: (params, state, {})


def half(job):
    step = job._step

    def halved(state, images, labels, probe):
        b = images.shape[0] // 2
        return step(state, images[:b], labels[:b], probe)

    job._step = halved


FAULTS = {"unchanged": unchanged, "half": half}
