"""Three-term roofline of one rank's traced step (counterpart of
``repro.analysis.roofline``):

  compute term    = traced FLOPs / peak FLOP/s          (per rank)
  memory term     = traced bytes accessed / HBM bw      (per rank)
  collective term = collective bytes / link bw           (per rank)

on the H100's constants (:mod:`repro_torch.launch.mesh`).  The counts come
from :func:`repro_torch.obs.audit.trace_step`, which runs rank 0's step
once under the dry run's ``fake`` process group: there is no compiled
program and no HLO, so nothing here is named ``hlo_*``.  FLOPs are
``torch.utils.flop_counter``'s per-op formulas, bytes accessed an eager
op's traffic (each op reads its tensor arguments and writes its results:
no fusion), and the collective bytes the result buffers of the port's
collectives by kind (:func:`repro_torch.exec.collectives.tally`), as the
reference's ``collective_bytes`` sums them from the HLO.

A trace counts every op it executes, a loop's body as often as it runs,
so the reference's undercount of a scanned loop body
(``tests/test_sharding_roofline.py::test_xla_counts_loop_body_once``)
does not happen here.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per training step
(3x fwd matmul flops 2·N·D for fwd+bwd); for decode, 2·N·D per token.
The ratio MODEL_FLOPS / traced FLOPs measures how much executed compute is
"useful" (catches remat/redundancy waste, and heads that run whole on
every rank of the model axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    traced_flops: float         # per rank
    traced_bytes: float         # per rank, bytes accessed
    coll_bytes: float           # per rank
    coll_detail: Dict[str, int]
    model_flops_global: float
    peak_bytes: int
    temp_bytes: int
    arg_bytes: int
    out_bytes: int

    @property
    def t_compute(self) -> float:
        return self.traced_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.traced_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global traced flops)."""
        total = self.traced_flops * self.n_chips
        return self.model_flops_global / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_chip": self.traced_flops,
            "bytes_per_chip": self.traced_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "peak_bytes_per_chip": self.peak_bytes,
            "temp_bytes_per_chip": self.temp_bytes,
            "arg_bytes_per_chip": self.arg_bytes,
            "out_bytes_per_chip": self.out_bytes,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D for train (N = active params), 2·N·D for prefill,
    2·N per token for decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch  # one token per sequence


def analyze(traced: dict, cfg, shape, mesh_name: str,
            n_chips: int) -> Roofline:
    """The roofline of a :func:`~repro_torch.obs.audit.trace_step`
    record."""
    coll = dict(traced.get("collective_bytes", {}))
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        traced_flops=float(traced["flops"]),
        traced_bytes=float(traced["bytes_accessed"]),
        coll_bytes=float(sum(coll.values())), coll_detail=coll,
        model_flops_global=model_flops(cfg, shape),
        peak_bytes=int(traced["peak_bytes"]),
        temp_bytes=int(traced["temp_size_in_bytes"]),
        arg_bytes=int(traced["argument_size_in_bytes"]),
        out_bytes=int(traced["output_size_in_bytes"]))
