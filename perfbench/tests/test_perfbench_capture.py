"""The readers of the program's capture (``recompute_ms``, ``optimizer_ms``,
``host_paced_share``) on a hand-made capture, and their silence where
there is nothing to read: no profile, no capture, no device times, or a
program that keeps no capture at all."""

from types import SimpleNamespace

import pytest

from harness import spec
from repro_torch import obs
from repro_torch.obs.capture import Capture, Record

NAMES = ("recompute_ms", "optimizer_ms", "host_paced_share")
US = 1_000  # ns


def _capture(lag_us=5):
    """Two steps' worth of ranges (host and device ns): a backward row that
    recomputes (queue full, the device 1 ms behind), then an SGD update
    the host paces (the device reaches each boundary within the lag)."""
    cap = Capture()
    cap.idle_lag_ns = lag_us * US
    R = Record
    cap.records = [
        # bp_row 0..100 us host; device 1,000..4,000 us: far behind
        R("bp_row", None, {"tick": 1}, (0, 100 * US), (1_000 * US,
                                                       4_000 * US)),
        R("row_recompute", 0, {}, (10 * US, 50 * US), (1_000 * US,
                                                       2_500 * US)),
        R("row_recompute", 1, {}, (20 * US, 30 * US), (1_200 * US,
                                                       1_300 * US)),
        # sgd_update 5,000..5,600 us host; the device follows within 3 us
        R("sgd_update", None, {}, (5_000 * US, 5_600 * US),
          (5_003 * US, 5_602 * US)),
        R("row_recompute", None, {}, (6_000 * US, 6_100 * US),
          (6_001 * US, 6_500 * US)),
    ]
    return cap


def _read(name, run):
    return spec.metric(name).read(run)


@pytest.fixture
def last(monkeypatch):
    def put(cap):
        monkeypatch.setattr(obs, "_last", cap)
    return put


RUN = SimpleNamespace(profile={"steps": 2})


def test_recompute_and_optimizer_ms_per_step(last):
    last(_capture())
    # outermost row_recompute ranges: 1.5 ms + 0.499 ms, over 2 steps
    assert _read("recompute_ms", RUN) == pytest.approx((1.5 + 0.499) / 2)
    assert _read("optimizer_ms", RUN) == pytest.approx(0.599 / 2)


def test_host_paced_share(last):
    cap = _capture()
    last(cap)
    # device boundaries in host order: 1000 1000 1200 1300 2500 4000 |
    # 5003 5602 | 6001 6500; lag at each end: the first six ends are
    # 990+ us behind, the rest 1-3 us (paced) except 6500 (400 us)
    paced = (5_003 - 4_000) + (5_602 - 5_003) + (6_001 - 5_602)
    total = 6_500 - 1_000
    assert _read("host_paced_share", RUN) == pytest.approx(
        100 * paced / total)
    # the threshold is the anchor's lag plus 100 us: a device 110 us
    # behind at 5,602 leaves that interval out
    cap.records[3].device_ns = (5_003 * US, 5_710 * US)
    paced = (5_003 - 4_000) + (6_001 - 5_710)
    assert _read("host_paced_share", RUN) == pytest.approx(
        100 * paced / total)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name, last, monkeypatch):
    last(_capture())
    assert _read(name, SimpleNamespace(profile=None)) is None
    assert _read(name, SimpleNamespace(profile={})) is None
    last(None)
    assert _read(name, RUN) is None
    with obs.profiling("cpu") as cpu:  # host times only
        with obs.profile_range("row_recompute"), \
                obs.profile_range("sgd_update"):
            pass
    assert obs.last_capture() is cpu
    assert _read(name, RUN) is None
    # a program that keeps no capture (the readers' first parent)
    monkeypatch.delattr(obs, "last_capture")
    last(_capture())
    assert _read(name, RUN) is None


def test_recompute_ms_reads_nothing_without_recomputed_rows(last):
    cap = _capture()
    cap.records = [r for r in cap.records if r.name != "row_recompute"]
    for r in cap.records:
        r.parent = None
    last(cap)
    assert _read("recompute_ms", RUN) is None
    assert _read("optimizer_ms", RUN) is not None
