"""The share of the profiled steps' device time in which the host set the
pace, from the capture the program keeps while ``obs.profiling()`` runs
(``repro_torch.obs.last_capture``).

Every start and end of a program range is a boundary with two times: when
the host got there, and when the device got there (the range's CUDA
event, put on the host's clock through the capture's anchor).  Taken in
the host's order, consecutive boundaries bound intervals of device time.
An interval is host-paced when the device had drained its queue by its
end: it reached the end boundary no more than the threshold after the
host did.  The threshold is the empty-queue lag the capture measured at
its anchor (``idle_lag_ns``: a fresh event on the drained device) plus
``DRAIN_NS``, 100 us: the launch and the run of about one short kernel
left queued (a row's last elementwise kernel, an optimizer leaf's
update).  On an H100 the share read from ResNet-50's 2PS-H steps is flat
from 100 to 200 us of slack, and VGG-16's reads the same at any slack
up to 1 ms.  The share is the host-paced intervals' device time over the
device time from the first boundary to the last.  Nothing where the
program keeps no capture or no device times."""

#: queued work, beyond the empty-queue lag, that still counts as drained
DRAIN_NS = 100_000


def share(cap):
    """The host-paced share of ``cap``, in %; None without device times."""
    marks = []
    for rec in cap.records:
        if rec.device_ns is None:
            return None
        marks += zip(rec.host_ns, rec.device_ns)
    if cap.idle_lag_ns is None or len(marks) < 2:
        return None
    limit = cap.idle_lag_ns + DRAIN_NS
    marks.sort()
    total = paced = 0
    last = marks[0][1]
    for host, dev in marks[1:]:
        dev = max(dev, last)  # one stream: the device keeps host order
        if dev - host <= limit:
            paced += dev - last
        total += dev - last
        last = dev
    return 100.0 * paced / total if total > 0 else None


def read(run):
    if not run.profile:
        return None
    from repro_torch import obs
    last = getattr(obs, "last_capture", None)
    cap = last() if last else None
    return share(cap) if cap else None
