"""Serializable execution plans — counterpart of ``repro.exec.plan``.

An :class:`ExecutionPlan` records *what* to run (engine, granularity N,
kernel policy) and *why* (estimated peak bytes, budget, feasibility); it is
plain data, JSON round-trippable and hashable.

Names differ from the reference in one place: kernel backends are
``"plain"`` (the reference's ``"lax"``) and ``"cuda"`` (``"pallas"``), and
the kernel-backed engines are ``overlap_cuda``, ``seq_swa_cuda`` and
``seq_ssd_cuda`` (``overlap_pallas``, ``seq_swa_pallas``,
``seq_ssd_pallas``).
:data:`REFERENCE_NAMES` is the one mapping; ``from_dict`` applies it, so a
plan JSON written by the reference loads here.  The reference's
``KernelSpec.interpret`` has no role in the port (where a tensor lies picks
kernel or plain version) and is dropped on load.

:class:`ResidencySpec` is executed by the row-program executor
(:mod:`repro_torch.exec.rowprog`), :class:`StageSpec` by the row pipeline
(:mod:`repro_torch.exec.pipeline`), and a :class:`MeshSpec` by the shard
wrappers :func:`repro_torch.exec.registry.build_apply` puts around an
engine, over a ``torch.distributed`` group
(:mod:`repro_torch.launch.mesh`).  All of them stay plain data here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple

#: reference name -> port name, for backends and engines
REFERENCE_NAMES = {"lax": "plain", "pallas": "cuda",
                   "overlap_pallas": "overlap_cuda",
                   "seq_swa_pallas": "seq_swa_cuda",
                   "seq_ssd_pallas": "seq_ssd_cuda"}

KERNEL_BACKENDS = ("plain", "cuda")


def port_name(name: str) -> str:
    return REFERENCE_NAMES.get(name, name)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device-mesh description: ordered ``(name, size)`` axes plus which
    axis carries data and which model parallelism."""

    axes: Tuple[Tuple[str, int], ...]
    data_axis: str = "data"
    model_axis: str = "model"

    KNOWN_AXES = ("pod", "data", "model")

    def __post_init__(self):
        axes = tuple((str(n), int(s)) for n, s in self.axes)
        if not axes:
            raise ValueError("MeshSpec needs at least one axis")
        names = [n for n, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names in {names}")
        for n, s in axes:
            if s < 1:
                raise ValueError(f"mesh axis {n!r} has size {s} < 1")
        object.__setattr__(self, "axes", axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def extent(self, name: str) -> int:
        """Size of axis ``name`` (1 when the axis is absent)."""
        return dict(self.axes).get(name, 1)

    @property
    def data(self) -> int:
        return self.extent(self.data_axis)

    @property
    def model(self) -> int:
        """Extent of the model axis (1 when the mesh has none)."""
        return self.extent(self.model_axis)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Axes the batch divides over: "pod" when present, then the data
        axis (the logical name "batch" of :mod:`repro_torch.launch.
        sharding`)."""
        return tuple(n for n, _ in self.axes
                     if n == "pod" or n == self.data_axis)

    @property
    def batch_extent(self) -> int:
        """Data-parallel extent (pod x data axes)."""
        n = 1
        for name in self.batch_axes:
            n *= self.extent(name)
        return n

    @classmethod
    def parse(cls, s: str) -> "MeshSpec":
        axes = []
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad mesh axis {part!r}; expected name=N")
            name, v = (t.strip() for t in part.split("=", 1))
            if name not in cls.KNOWN_AXES:
                raise ValueError(f"unknown mesh axis {name!r}; expected one "
                                 f"of {cls.KNOWN_AXES}")
            axes.append((name, int(v)))
        return cls(axes=tuple(axes))

    def describe(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self.axes)

    def to_dict(self) -> dict:
        return {"axes": [list(a) for a in self.axes],
                "data_axis": self.data_axis, "model_axis": self.model_axis}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        return cls(axes=tuple(tuple(a) for a in d["axes"]),
                   data_axis=d.get("data_axis", "data"),
                   model_axis=d.get("model_axis", "model"))


def batch_shards(mesh: Optional[MeshSpec], batch: int) -> int:
    """The mesh's batch extent when it divides the batch, else 1."""
    if mesh is None:
        return 1
    k = mesh.batch_extent
    return k if k > 0 and batch % k == 0 else 1


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Kernel-execution policy: ``backend`` ``"plain"`` (the reference
    engines) or ``"cuda"`` (the kernel-backed engines), plus per-kernel
    tiles (``block_h`` for ``conv2d_rows``, ``bq``/``bk`` for
    ``swa_attention``, ``chunk`` for ``ssd_scan``)."""

    backend: str = "plain"
    block_h: int = 8
    bq: int = 128
    bk: int = 128
    chunk: int = 128

    def __post_init__(self):
        if self.backend not in KERNEL_BACKENDS:
            raise ValueError(f"unknown kernel backend {self.backend!r}; "
                             f"expected one of {KERNEL_BACKENDS}")
        for f in ("block_h", "bq", "bk", "chunk"):
            if getattr(self, f) < 1:
                raise ValueError(f"KernelSpec.{f} must be >= 1, got "
                                 f"{getattr(self, f)}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelSpec":
        d = {k: v for k, v in d.items() if k != "interpret"}
        if "backend" in d:
            d["backend"] = port_name(d["backend"])
        return cls(**d)


RESIDENCY_POLICIES = ("device", "host", "recompute")


@dataclasses.dataclass(frozen=True)
class ResidencySpec:
    """Boundary-cache residency policy (plain data): ``default`` for every
    named cache, per-name ``placements`` overrides, ``prefetch_depth``."""

    default: str = "device"
    placements: Tuple[Tuple[str, str], ...] = ()
    prefetch_depth: int = 1

    def __post_init__(self):
        placements = tuple(sorted((str(n), str(p))
                                  for n, p in self.placements))
        for p in (self.default,) + tuple(p for _, p in placements):
            if p not in RESIDENCY_POLICIES:
                raise ValueError(f"unknown residency policy {p!r}; expected "
                                 f"one of {RESIDENCY_POLICIES}")
        names = [n for n, _ in placements]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cache names in placements: {names}")
        if self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got "
                             f"{self.prefetch_depth}")
        object.__setattr__(self, "placements", placements)

    @classmethod
    def parse(cls, s: str) -> Optional["ResidencySpec"]:
        s = s.strip()
        return cls(default=s) if s else None

    def placement(self, name: str) -> str:
        """Policy for the boundary cache called ``name``."""
        for n, p in self.placements:
            if n == name:
                return p
        return self.default

    @property
    def offloads(self) -> bool:
        return self.default != "device" \
            or any(p != "device" for _, p in self.placements)

    def describe(self) -> str:
        bits = [self.default] + [f"{n}:{p}" for n, p in self.placements]
        if "host" in (self.default,) + tuple(p for _, p in self.placements):
            bits.append(f"prefetch={self.prefetch_depth}")
        return ",".join(bits)

    def to_dict(self) -> dict:
        return {"default": self.default,
                "placements": [list(p) for p in self.placements],
                "prefetch_depth": self.prefetch_depth}

    @classmethod
    def from_dict(cls, d: dict) -> "ResidencySpec":
        return cls(default=d.get("default", "device"),
                   placements=tuple(tuple(p)
                                    for p in d.get("placements", ())),
                   prefetch_depth=d.get("prefetch_depth", 1))


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Pipeline-stage partition (plain data): contiguous half-open module
    ranges starting at 0."""

    stages: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        stages = tuple((int(a), int(b)) for a, b in self.stages)
        if not stages:
            raise ValueError("StageSpec needs at least one stage")
        if stages[0][0] != 0:
            raise ValueError(f"first stage must start at module 0, got "
                             f"{stages[0]}")
        for i, (a, b) in enumerate(stages):
            if b <= a:
                raise ValueError(f"stage {i} range ({a}, {b}) is empty")
            if i and a != stages[i - 1][1]:
                raise ValueError(f"stages must be contiguous: stage {i} "
                                 f"starts at {a} but stage {i - 1} ends at "
                                 f"{stages[i - 1][1]}")
        object.__setattr__(self, "stages", stages)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_modules(self) -> int:
        return self.stages[-1][1]

    @classmethod
    def even(cls, n_modules: int, n_stages: int) -> "StageSpec":
        """Split ``n_modules`` into ``n_stages`` contiguous near-even
        ranges (the remainder spreads over the leading stages)."""
        if not 1 <= n_stages <= n_modules:
            raise ValueError(f"cannot split {n_modules} modules into "
                             f"{n_stages} stages")
        base, rem = divmod(n_modules, n_stages)
        stages, start = [], 0
        for s in range(n_stages):
            end = start + base + (1 if s < rem else 0)
            stages.append((start, end))
            start = end
        return cls(stages=tuple(stages))

    def describe(self) -> str:
        return "|".join(f"{a}:{b}" for a, b in self.stages)

    def to_dict(self) -> dict:
        return {"stages": [list(s) for s in self.stages]}

    @classmethod
    def from_dict(cls, d: dict) -> "StageSpec":
        return cls(stages=tuple(tuple(s) for s in d["stages"]))


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """What a config asks for; the Planner resolves it to a plan.  Pin
    ``engine`` and ``n_rows``, or leave them for the solver."""

    engine: str = ""
    n_rows: int = 0
    budget_gb: float = 0.0
    n_segments: Optional[int] = None
    mesh: str = ""
    kernel: str = ""        # "cuda" = kernel-backed engines; "plain"/"" not
    residency: str = ""


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A resolved, serializable execution policy (see the reference's
    ``ExecutionPlan`` for every field's meaning; the fields are the
    same)."""

    engine: str
    n_rows: int = 1
    in_shape: Optional[Tuple[int, int, int]] = None
    batch: int = 1
    dtype_bytes: int = 4
    n_segments: Optional[int] = None
    segments: Tuple[Tuple[int, int, int], ...] = ()
    est_bytes: int = 0
    est_bytes_per_device: int = 0
    budget: int = 0
    feasible: bool = True
    mesh: Optional[MeshSpec] = None
    kernel: Optional[KernelSpec] = None
    residency: Optional[ResidencySpec] = None
    stage: Optional[StageSpec] = None
    extras: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "extras", tuple(sorted(self.extras)))
        object.__setattr__(self, "segments",
                           tuple(tuple(s) for s in self.segments))
        if self.in_shape is not None:
            object.__setattr__(self, "in_shape", tuple(self.in_shape))
        if not self.est_bytes_per_device and self.est_bytes:
            object.__setattr__(self, "est_bytes_per_device",
                               self.est_bytes // self.data_shards)

    @property
    def h0(self) -> int:
        if self.in_shape is None:
            raise ValueError(f"plan for engine {self.engine!r} has no "
                             f"in_shape")
        return self.in_shape[0]

    @property
    def data_shards(self) -> int:
        return batch_shards(self.mesh, self.batch)

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.extras:
            if k == key:
                return v
        return default

    def with_extras(self, **kv) -> "ExecutionPlan":
        extras = tuple((k, v) for k, v in self.extras if k not in kv) \
            + tuple(kv.items())
        return dataclasses.replace(self, extras=extras)

    def per_device(self) -> "ExecutionPlan":
        """This plan projected onto ONE device: batch and budget divided by
        the data extent, estimates per device, mesh dropped (the stage
        partition stays).  Identity for an unsharded plan."""
        if self.mesh is None:
            return self
        k = self.data_shards
        repl = dataclasses.replace(
            self, mesh=None, batch=self.batch // k,
            est_bytes=self.est_bytes_per_device,
            est_bytes_per_device=self.est_bytes_per_device,
            budget=self.budget // k)
        if self.engine == "serve_pool":
            # decode slots ARE the batch: shard the slot count too
            repl = dataclasses.replace(repl, n_rows=max(1, self.n_rows // k))
        return repl

    @classmethod
    def explicit(cls, engine: str, n_rows: int = 1,
                 in_shape: Optional[Tuple[int, int, int]] = None,
                 n_segments: Optional[int] = None,
                 mesh: Optional[MeshSpec] = None,
                 kernel: Optional[KernelSpec] = None,
                 residency: Optional[ResidencySpec] = None,
                 stage: Optional[StageSpec] = None,
                 **extras) -> "ExecutionPlan":
        """An unestimated plan pinning (engine, N)."""
        return cls(engine=engine, n_rows=n_rows, in_shape=in_shape,
                   n_segments=n_segments, mesh=mesh, kernel=kernel,
                   residency=residency, stage=stage,
                   extras=tuple(extras.items()))

    def describe(self) -> str:
        bits = [f"engine={self.engine}", f"N={self.n_rows}"]
        if self.mesh is not None:
            bits.append(f"mesh={self.mesh.describe()}")
        if self.segments:
            bits.append(f"segments={len(self.segments)}")
        if self.est_bytes:
            bits.append(f"est={self.est_bytes / 2**20:.1f}MiB")
        if self.budget:
            bits.append(f"budget={self.budget / 2**20:.1f}MiB")
            bits.append(f"feasible={self.feasible}")
        if self.kernel is not None:
            bits.append(f"kernel={self.kernel.backend}")
        if self.residency is not None:
            bits.append(f"residency={self.residency.describe()}")
        if self.stage is not None:
            bits.append(f"stages={self.stage.describe()}")
        for k, v in self.extras:
            bits.append(f"{k}={v}")
        return "ExecutionPlan(" + " ".join(bits) + ")"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["in_shape"] = list(self.in_shape) if self.in_shape else None
        d["segments"] = [list(s) for s in self.segments]
        d["extras"] = {k: v for k, v in self.extras}
        for f in ("mesh", "kernel", "residency", "stage"):
            v = getattr(self, f)
            d[f] = v.to_dict() if v is not None else None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        """Load a plan dict written by this package or by the reference
        (names mapped through :data:`REFERENCE_NAMES`)."""
        d = dict(d)
        d["engine"] = port_name(d["engine"])
        if d.get("in_shape") is not None:
            d["in_shape"] = tuple(d["in_shape"])
        d["segments"] = tuple(tuple(s) for s in d.get("segments", ()))
        d["extras"] = tuple(sorted(d.get("extras", {}).items()))
        for f, spec in (("mesh", MeshSpec), ("kernel", KernelSpec),
                        ("residency", ResidencySpec), ("stage", StageSpec)):
            if d.get(f) is not None:
                d[f] = spec.from_dict(d[f])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))
