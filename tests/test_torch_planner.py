"""The port's planner integers and plan JSON against the JAX package.

``repro.exec`` cannot be imported where ``jax.sharding`` lacks
``TransferToMemoryKind``, so the reference's ``exec/plan.py`` (which
imports only ``dataclasses`` and ``json``) is loaded by file path, and the
memory model is compared through ``repro.core.rowplan`` / ``twophase``.
Integers must be equal.  For the same reason the sequence planner
(``Planner.for_model``, ``seq_estimate``) is compared with constants
computed here from the reference's Eq. 7 formula
(``src/repro/exec/planner.py``, ``Planner.seq_estimate``).
"""

import dataclasses
import importlib.util
import pathlib
import sys

import pytest
import torch

from repro.core import rowplan as ref_rp
from repro.core import twophase as ref_tp
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro_torch.core import rowplan as pt_rp
from repro_torch.core import twophase as pt_tp
from repro_torch.exec import ExecutionPlan, KernelSpec, PlanRequest, Planner
from repro_torch.exec.planner import kernelize_plan
from repro_torch.models.cnn.vgg import vgg16_modules

REF_PLAN_PATH = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro" / "exec" / "plan.py"


def _ref_plan_module():
    name = "_reference_exec_plan"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REF_PLAN_PATH)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # dataclasses resolve annotations here
        spec.loader.exec_module(mod)
    return sys.modules[name]


# (width_mult, n_stages, image): a small trunk and full VGG-16 at 224
TRUNKS = [(0.125, 3, 32), (0.125, 5, 64), (1.0, 5, 224)]


def _mods(width, stages):
    return ref_vgg16_modules(width, stages), vgg16_modules(width, stages)


@pytest.mark.parametrize("width,stages,image", TRUNKS)
@pytest.mark.parametrize("engine", ["base", "overlap", "twophase"])
def test_estimate_bytes_equal(width, stages, image, engine):
    ref_m, pt_m = _mods(width, stages)
    shape = (image, image, 3)
    h_last = ref_rp.shape_chain(ref_m, shape)[-1][0]
    for batch in (1, 2, 32):
        for n in range(1, min(4, h_last) + 1):
            if engine == "twophase" and not ref_tp.validate_plan(
                    ref_tp.module_boundaries(ref_m, image, n)):
                continue
            assert pt_rp.estimate_bytes(pt_m, shape, batch, engine, n) \
                == ref_rp.estimate_bytes(ref_m, shape, batch, engine, n)
        assert pt_rp.omega_column(pt_m, shape, batch) \
            == ref_rp.omega_column(ref_m, shape, batch)


@pytest.mark.parametrize("width,stages,image", TRUNKS)
@pytest.mark.parametrize("engine", ["base", "overlap", "twophase"])
def test_solve_n_equal(width, stages, image, engine):
    ref_m, pt_m = _mods(width, stages)
    shape = (image, image, 3)
    full = ref_rp.omega_column(ref_m, shape, 2)
    for budget in (full // 8, full // 3, full // 2, full * 2):
        got = pt_rp.solve_n(pt_m, shape, 2, budget, engine, xi=1000)
        want = ref_rp.solve_n(ref_m, shape, 2, budget, engine, xi=1000)
        assert (got.n_rows, got.est_bytes, got.feasible) \
            == (want.n_rows, want.est_bytes, want.feasible)


def test_largest_batch_and_image_equal():
    ref_m, pt_m = _mods(0.125, 3)
    budget = 8 * 2**20
    for engine in ("base", "overlap"):
        assert pt_rp.largest_batch(pt_m, (32, 32, 3), budget, engine,
                                   b_max=256) \
            == ref_rp.largest_batch(ref_m, (32, 32, 3), budget, engine,
                                    b_max=256)
        assert pt_rp.largest_image(lambda h: pt_m, (32, 32, 3), 2, budget,
                                   engine, h_max=256) \
            == ref_rp.largest_image(lambda h: ref_m, (32, 32, 3), 2, budget,
                                    engine, h_max=256)


@pytest.mark.parametrize("width,stages,image", TRUNKS)
def test_twophase_planning_equal(width, stages, image):
    ref_m, pt_m = _mods(width, stages)
    h_last = ref_rp.shape_chain(ref_m, (image, image, 3))[-1][0]
    for n in (n for n in (1, 2, 3, 4, 6) if n <= h_last):
        want = ref_tp.module_boundaries(ref_m, image, n)
        got = pt_tp.module_boundaries(pt_m, image, n)
        assert (got.heights, got.bounds, got.need_lo) \
            == (want.heights, want.bounds, want.need_lo)
        assert pt_tp.validate_plan(got) == ref_tp.validate_plan(want)
        assert got.cache_sizes() == want.cache_sizes()
        assert pt_rp.twophase_cache_bytes(pt_m, (image, image, 3), 2, n) \
            == ref_rp.twophase_cache_bytes(ref_m, (image, image, 3), 2, n)
        assert pt_rp.overlap_halo_bytes(pt_m, (image, image, 3), 2, n) \
            == ref_rp.overlap_halo_bytes(ref_m, (image, image, 3), 2, n)
    assert pt_tp.max_valid_rows(pt_m, image) \
        == ref_tp.max_valid_rows(ref_m, image)


def test_reference_plan_json_loads_with_name_mapping():
    R = _ref_plan_module()
    ref = R.ExecutionPlan(
        engine="overlap_pallas", n_rows=4, in_shape=(224, 224, 3), batch=32,
        est_bytes=123456, budget=2**30, feasible=True,
        mesh=R.MeshSpec.parse("data=1"),
        kernel=R.KernelSpec(backend="pallas", block_h=16, interpret=True),
        residency=R.ResidencySpec(default="device",
                                  placements=(("sd_l3", "device"),)),
        stage=R.StageSpec.even(31, 2),
        extras=(("kernel_layers", 13), ("n_rows_bp", 6)))
    got = ExecutionPlan.from_json(ref.to_json())
    assert got.engine == "overlap_cuda"
    assert got.kernel == KernelSpec(backend="cuda", block_h=16)
    assert (got.n_rows, got.in_shape, got.batch, got.est_bytes, got.budget) \
        == (4, (224, 224, 3), 32, 123456, 2**30)
    assert got.mesh.axes == ref.mesh.axes
    assert got.residency.to_dict() == ref.residency.to_dict()
    assert got.stage.stages == ref.stage.stages
    assert got.extras == ref.extras
    assert ExecutionPlan.from_json(got.to_json()) == got
    # a reference plan on the lax backend maps to the plain one
    lax = R.ExecutionPlan(engine="overlap", n_rows=2,
                          kernel=R.KernelSpec(backend="lax"))
    assert ExecutionPlan.from_json(lax.to_json()).kernel.backend == "plain"


def test_plan_json_roundtrip_and_describe():
    plan = Planner(vgg16_modules(1.0, 5), (224, 224, 3), 32).plan(
        "overlap", 4, budget=24 * 2**30)
    assert ExecutionPlan.from_json(plan.to_json()) == plan
    assert plan.describe().startswith("ExecutionPlan(engine=overlap N=4")
    with pytest.raises(ValueError, match="backend"):
        KernelSpec(backend="pallas")


@pytest.mark.parametrize("engine,n", [("base", 1), ("overlap", 2),
                                      ("overlap", 4), ("twophase", 2)])
def test_planner_estimates_match_rowplan(engine, n):
    ref_m, pt_m = _mods(1.0, 5)
    shape, xi = (224, 224, 3), 12345
    plan = Planner(pt_m, shape, 32, xi=xi).plan(engine, n, budget=2**33)
    want = (ref_rp.omega_column(ref_m, shape, 32) + xi) if engine == "base" \
        else ref_rp.estimate_bytes(ref_m, shape, 32, engine, n, xi=xi)
    assert plan.est_bytes == plan.est_bytes_per_device == want
    assert plan.feasible == (want < 2**33)
    solved = Planner(pt_m, shape, 32, xi=xi).solve(engine, want + 1)
    assert solved.feasible


def test_kernelize_swaps_in_overlap_cuda():
    mods = vgg16_modules(1.0, 5)
    planner = Planner(mods, (224, 224, 3), 32)
    for engine in ("overlap", "base"):
        plan = planner.kernelize(planner.plan(engine, 4), "cuda")
        assert plan.engine == "overlap_cuda"
        assert plan.kernel == KernelSpec(backend="cuda", block_h=8)
        assert plan.get("kernel_layers") == 13
        # the wide Cout tile's layout at block_h=8 (85,968 B; the Cout=64
        # layers take 49,104 B)
        assert plan.get("kernel_smem_bytes") == 85968
    req = PlanRequest(engine="overlap", n_rows=4, kernel="cuda")
    assert planner.resolve(req).engine == "overlap_cuda"
    plain = planner.resolve(dataclasses.replace(req, kernel="plain"))
    assert plain.engine == "overlap" and plain.kernel.backend == "plain"


def test_kernelize_fallbacks_and_retile():
    mods = vgg16_modules(1.0, 5)
    planner = Planner(mods, (224, 224, 3), 32)
    plan = planner.plan("overlap", 4)
    # a pinned spec never re-tiles: infeasible means fall back, with why
    pinned = kernelize_plan(plan, KernelSpec(backend="cuda", block_h=2),
                            mods, smem_limit=25000)
    assert pinned.engine == "overlap" and pinned.kernel.backend == "plain"
    assert "shared memory" in pinned.get("kernel_fallback")
    # a bare "cuda" searches candidate_tiles in order: a k=10 conv fails
    # the halo rule at the default block_h=8 and fits at the first
    # candidate, 32 (223,988 B of shared memory: 4-channel chunks, one
    # CTA per SM)
    from repro_torch.models.cnn.layers import Conv
    wide = [Conv(4, k=10, s=1, p=0)]
    p10 = Planner(wide, (64, 64, 3), 2).plan("overlap", 1)
    retiled = kernelize_plan(p10, "cuda", wide)
    assert retiled.engine == "overlap_cuda"
    assert retiled.kernel.block_h == 32
    assert "block_h=32" in retiled.get("kernel_retile")
    assert retiled.get("kernel_smem_bytes") == 223988
    assert kernelize_plan(p10, "cuda", wide, smem_limit=200000) \
        .get("kernel_fallback")
    tp = planner.kernelize(planner.plan("twophase", 2), "cuda")
    assert tp.engine == "twophase"
    assert "no cuda alternate" in tp.get("kernel_fallback")
    half = dataclasses.replace(plan, dtype_bytes=2)
    assert "fp32" in planner.kernelize(half, "cuda").get("kernel_fallback")


def test_unported_planning_raises():
    """What a plan cannot do in one process raises: a serving plan over a
    mesh answers (its slots split over the batch axes,
    ``tests/test_torch_serve_sharding.py`` holds it to the reference), and
    its pool needs a rank a coordinate.  Staging over a model axis (in
    ``stagedize`` and as the costed chooser's staged alternates) is ported
    and answers here; ``tests/test_torch_pipeline.py`` holds its answers
    to the reference's.  The costed chooser and ``autotune_kernel``
    themselves are ported (``tests/test_torch_costmodel.py``)."""
    from repro_torch.exec import CostTable, MeshSpec
    mods = vgg16_modules(0.125, 3)
    planner = Planner(mods, (32, 32, 3), 2)
    costed = Planner.for_budget(mods, (32, 32, 3), 2, 2**20,
                                mesh=MeshSpec.parse("data=1,model=2"),
                                cost_table=CostTable(fingerprint="t"))
    assert costed.feasible and costed.get("cost_model")
    from repro_torch.configs import get_reduced
    sharded = Planner.for_serve(get_reduced("qwen1_5_4b"), 32, n_slots=3,
                                mesh=MeshSpec.parse("data=2"))
    assert (sharded.n_rows, sharded.get("slots_per_device")) == (4, 2)
    from repro_torch.serve import make_pool
    with pytest.raises(ValueError, match="per_device"):
        make_pool(get_reduced("qwen1_5_4b"), sharded, device="cpu")
    tuned = planner.autotune_kernel(planner.plan("twophase", 2),
                                    time_fn=lambda c: 1.0)
    assert "no cuda alternate" in tuned.get("kernel_fallback")
    # stagedize: a no-op without a model axis, as in the reference; it
    # raises only where it would have to stage
    tight = planner.plan("base", 1, budget=1)
    assert not tight.feasible and planner.stagedize(tight) is tight
    # with a model axis it stages: xi alone breaks one stage, half of it
    # fits
    staged = Planner(mods, (32, 32, 3), 2, xi=3 * 2**20,
                     mesh=MeshSpec.parse("data=1,model=2"))
    tight = staged.plan("base", 1, budget=3 * 2**20)
    assert not tight.feasible
    assert staged.stagedize(tight).engine == "pipeline_rows"
    # the hybrids and 2PS have no CUDA alternate (as in the reference,
    # which has no 2PS kernel engine)
    for engine in ("ckp", "twophase_h", "overlap_h"):
        plan = planner.kernelize(planner.plan(engine, 2), "cuda")
        assert plan.engine == engine
        assert "no cuda alternate" in plan.get("kernel_fallback")


# ---------------------------------------------------------------------------
# Sequence planning (Eq. 7 along the token axis) and the swa kernel pass
# ---------------------------------------------------------------------------


def _eq7(seq, d, d_ff, batch, n, window, db):
    """The reference's seq_estimate: residual stream + one chunk's widest
    sub-layer working set (+ the SWA halo)."""
    width = max(3 * d, 2 * (d_ff or 4 * d))
    return batch * seq * d * db + batch * (-(-seq // n) + window) * width * db


def _gemma(preset, **kw):
    from repro_torch.configs import get_config, get_reduced
    cfg = get_reduced("gemma3_4b") if preset == "reduced" \
        else get_config("gemma3_4b")
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("preset,batch,seq,est,db", [
    ("reduced", 2, 64, 524288, 4),
    ("full", 1, 4096, 83886080, 2),
])
def test_for_model_gemma(preset, batch, seq, est, db):
    cfg = _gemma(preset)
    assert est == _eq7(seq, cfg.d_model, cfg.d_ff, batch, cfg.row_chunks,
                       cfg.sliding_window, db)
    plan = Planner.for_model(cfg, batch, seq)
    assert plan.engine == "seq_swa_overlap"
    assert (plan.n_rows, plan.est_bytes, plan.est_bytes_per_device,
            plan.dtype_bytes, plan.batch) \
        == (cfg.row_chunks, est, est, db, batch)
    assert dict(plan.extras) == {"axis": 1, "seq": seq,
                                 "d_model": cfg.d_model,
                                 "window": cfg.sliding_window,
                                 "head_dim": cfg.head_dim}
    assert Planner.seq_estimate(seq, cfg.d_model, batch, cfg.row_chunks,
                                cfg.d_ff, cfg.sliding_window, db) == est
    # the depth cut the card runs changes no activation term of Eq. 7
    assert Planner.for_model(dataclasses.replace(cfg, n_layers=12), batch,
                             seq).est_bytes == est


def test_for_model_kernel_pass():
    full = _gemma("full", n_layers=12)
    plan = Planner.for_model(full, 1, 4096, kernel="cuda")
    assert plan.engine == "seq_swa_cuda"
    assert plan.kernel == KernelSpec(backend="cuda")
    assert plan.get("kernel_smem_bytes") == 196608  # tensor-core layout
    assert plan.get("kernel_fallback") is None
    assert plan.get("kernel_retile") is None
    plain = Planner.for_model(full, 1, 4096, kernel="plain")
    assert plain.engine == "seq_swa_overlap"
    assert plain.kernel.backend == "plain"
    # fp32 at head_dim 256: the default 128/128 tiles overflow shared
    # memory; a bare "cuda" retiles through candidate_tiles
    f32 = Planner.for_model(_gemma("full", dtype="float32"), 1, 4096,
                            kernel="cuda")
    assert f32.engine == "seq_swa_cuda"
    assert (f32.kernel.bq, f32.kernel.bk) == (256, 64)
    assert "bk=64 bq=256" in f32.get("kernel_retile")
    # a pinned spec never retiles: it falls back, saying why
    pinned = Planner.for_model(_gemma("full", dtype="float32"), 1, 4096,
                               kernel=KernelSpec(backend="cuda"))
    assert pinned.engine == "seq_swa_overlap"
    assert pinned.kernel.backend == "plain"
    assert "shared memory" in pinned.get("kernel_fallback")
    bad = kernelize_plan(Planner.for_model(_gemma("reduced"), 2, 96),
                         KernelSpec(backend="cuda", bq=64, bk=64))
    assert "does not tile" in bad.get("kernel_fallback")
    # the reduced config: tiles clamp to seq 64
    red = Planner.for_model(_gemma("reduced"), 2, 64, kernel="cuda")
    assert red.engine == "seq_swa_cuda"
    assert red.get("kernel_smem_bytes") == 41216  # fp32: the SIMT layout


def test_bf16_kernel_rules_retile_or_fall_back():
    """The bf16 tensor-core kernel's own rules (bq a multiple of 16 up to
    128; shared memory grows with bq) drive the retile."""
    full = _gemma("full", n_layers=12)
    base = Planner.for_model(full, 1, 4096)
    # a pinned q block of 256 rows needs 16 warps: fall back, saying why
    pinned = kernelize_plan(base, KernelSpec(backend="cuda", bq=256, bk=128))
    assert pinned.engine == "seq_swa_overlap"
    assert "bq=256" in pinned.get("kernel_fallback")
    # below the default tiles' 196,608 B: every bq=256 and bq=128 candidate
    # is refused, bq=64 (163,840 B) too; the first that fits is 32/32
    tight = kernelize_plan(base, "cuda", smem_limit=150000)
    assert tight.engine == "seq_swa_cuda"
    assert (tight.kernel.bq, tight.kernel.bk) == (32, 32)
    assert "196608 B" in tight.get("kernel_retile")
    assert tight.get("kernel_smem_bytes") == 2 * 256 * (32 + 256) == 147456
    # a 8-token sequence clamps bq to 8 < 16 and has no other candidate
    short = kernelize_plan(
        Planner.for_model(_gemma("reduced", dtype="bfloat16"), 2, 8), "cuda")
    assert short.engine == "seq_swa_overlap"
    assert "bq=8" in short.get("kernel_fallback")
    assert "no candidate tiling feasible" in short.get("kernel_fallback")


def test_for_budget_seq_smallest_fitting_chunk_count():
    cfg = _gemma("full")
    ests = {n: _eq7(4096, cfg.d_model, cfg.d_ff, 1, n, 1024, 2)
            for n in (1, 2, 4, 8, 16)}
    plan = Planner.for_model(cfg, 1, 4096, budget=ests[4] + 1)
    assert (plan.n_rows, plan.est_bytes, plan.feasible) == (4, ests[4], True)
    tight = Planner.for_budget_seq(4096, cfg.d_model, 1, 1, d_ff=cfg.d_ff,
                                   window=1024, dtype_bytes=2)
    assert not tight.feasible and tight.n_rows == 64


def test_seq_kernel_pass_for_ssd_and_unknown_engines():
    # as in the reference, a plan needs a 'seq' extra to be checked against
    bare = kernelize_plan(ExecutionPlan.explicit("seq_ssd_cuda"), "cuda")
    assert "no 'seq' extra" in bare.get("kernel_fallback")
    ssd = ExecutionPlan.explicit("seq_ssd_cuda", seq=4096)
    assert kernelize_plan(ssd, "cuda").engine == "seq_ssd_cuda"
    half = dataclasses.replace(ssd, dtype_bytes=2)
    assert "fp32-only" in kernelize_plan(half, "cuda").get("kernel_fallback")
    chunked = ExecutionPlan.explicit("seq_chunked", 4, seq=64)
    assert "no cuda alternate" in kernelize_plan(chunked, "cuda") \
        .get("kernel_fallback")


def test_reference_seq_plan_json_loads_as_cuda_engines():
    R = _ref_plan_module()
    for ref_engine, engine in (("seq_swa_pallas", "seq_swa_cuda"),
                               ("seq_ssd_pallas", "seq_ssd_cuda")):
        ref = R.ExecutionPlan(
            engine=ref_engine, n_rows=8, batch=1, dtype_bytes=2,
            est_bytes=83886080,
            kernel=R.KernelSpec(backend="pallas", bq=64, bk=32,
                                interpret=False),
            extras=(("seq", 4096), ("window", 1024), ("head_dim", 256)))
        got = ExecutionPlan.from_json(ref.to_json())
        assert got.engine == engine
        assert got.kernel == KernelSpec(backend="cuda", bq=64, bk=32)
        assert (got.n_rows, got.est_bytes, got.extras) \
            == (8, 83886080, ref.extras)


def test_ssd_kernelize_checks_in_the_reference_order():
    """seq extra, then chunk divides seq (``min(chunk, seq)``), then fp32,
    then the kernel's shared memory at the ``ssm_state`` extra."""
    pinned = KernelSpec(backend="cuda", chunk=48)
    plan = ExecutionPlan.explicit("seq_ssd_cuda", seq=64)
    assert "chunk=48 does not divide seq=64" in kernelize_plan(
        plan, pinned).get("kernel_fallback")
    # a chunk above seq clamps to it, as in the reference
    short = kernelize_plan(ExecutionPlan.explicit("seq_ssd_cuda", seq=64),
                           KernelSpec(backend="cuda", chunk=256))
    assert short.engine == "seq_ssd_cuda"
    # both faults: the divisibility rule speaks first
    half = dataclasses.replace(plan, dtype_bytes=2)
    assert "does not divide" in kernelize_plan(half, pinned) \
        .get("kernel_fallback")
    # Zamba2's N 64 at the default chunk 128: priced, no retile
    zamba = kernelize_plan(ExecutionPlan.explicit(
        "seq_ssd_cuda", seq=4096, ssm_state=64), "cuda")
    assert (zamba.engine, zamba.kernel.chunk) == ("seq_ssd_cuda", 128)
    assert zamba.get("kernel_smem_bytes") == 114688
    assert zamba.get("kernel_retile") is None


def test_ssd_retiles_to_a_fitting_chunk_or_falls_back():
    plan = ExecutionPlan.explicit("seq_ssd_cuda", seq=4096, ssm_state=128)
    # N 128 at chunk 128 needs 196,608 B (one stage): above a 150,000 B
    # limit a bare "cuda" walks candidate_tiles("ssd") (256: 358,400 B,
    # then 64: 115,712 B) to the first that fits
    assert kernelize_plan(plan, "cuda").kernel.chunk == 128
    auto = kernelize_plan(plan, "cuda", smem_limit=150000)
    assert (auto.engine, auto.kernel.chunk) == ("seq_ssd_cuda", 64)
    assert "196608 B" in auto.get("kernel_retile")
    assert "chunk=64" in auto.get("kernel_retile")
    assert auto.get("kernel_smem_bytes") == 115712
    # a pinned spec does not retile
    pinned = kernelize_plan(plan, KernelSpec(backend="cuda", chunk=256))
    assert "358400 B" in pinned.get("kernel_fallback")
    # too tight for any chunk: fall back, saying so
    tight = kernelize_plan(plan, "cuda", smem_limit=10000)
    assert "no candidate tiling feasible" in tight.get("kernel_fallback")
    # a sequence no candidate divides keeps the default's reason
    odd = kernelize_plan(ExecutionPlan.explicit("seq_ssd_cuda", seq=4100),
                         "cuda")
    assert "chunk=128 does not divide seq=4100" in odd.get(
        "kernel_fallback")


# ---------------------------------------------------------------------------
# The six CNN engines under residency, segments, solve, residencize and
# for_budget, against the reference's Planner (from a child process)
# ---------------------------------------------------------------------------

#: one query script, run here against the port and in the child against
#: the reference, so both answer the same questions; ``ns`` supplies each
#: package's names and the trunks
PLAN_QUERIES = r'''
def run(ns):
    Planner, PlanRequest, ResidencySpec = (ns["Planner"], ns["PlanRequest"],
                                           ns["ResidencySpec"])
    res = {"none": None, "device": ResidencySpec(),
           "host0": ResidencySpec("host", prefetch_depth=0),
           "host1": ResidencySpec("host"),
           "host2": ResidencySpec("host", prefetch_depth=2),
           "recompute": ResidencySpec("recompute"),
           "mixed": ResidencySpec("host", placements=(("sd_l1",
                                                       "recompute"),)),
           "pinned": ResidencySpec("host", placements=(("sd_l1",
                                                        "device"),))}
    engines = ("base", "ckp", "overlap", "twophase", "overlap_h",
               "twophase_h")

    def guard(fn):
        try:
            v = fn()
        except ValueError as e:
            return "ValueError"
        return v.to_dict() if hasattr(v, "to_dict") else v

    out = {}
    for name, (mods, shape, batch, xi) in ns["trunks"].items():
        pl = Planner(mods, shape, batch, xi=xi)
        h = shape[0]
        out[name + "|xi"] = xi
        for inner in ("column", "overlap", "twophase"):
            out[f"{name}|cap|{inner}"] = [list(t) for t in
                ns["segment_row_capacity"](mods, h, inner)]
            for n in (1, 2, 3, 8):
                out[f"{name}|seg|{inner}|{n}"] = [list(t) for t in
                    ns["derive_segments"](mods, h, inner, n, None)]
        for engine in engines:
            for n in (1, 3, 8):
                for rk, r in res.items():
                    out[f"{name}|est|{engine}|{n}|{rk}"] = guard(
                        lambda: pl.estimate(engine, n, residency=r))
            out[f"{name}|plan|{engine}"] = guard(
                lambda: pl.plan(engine, 2, budget=2**30,
                                residency=res["host1"]))
        base = pl.estimate("base", 1)
        # fewer budgets at full width, where every hybrid solve scans
        # segment caps over 31 modules
        fracs = (0.3, 0.7) if h == 224 else (0.25, 0.45, 0.7, 1.1)
        budgets = [int(base * f) for f in fracs]
        for b in budgets + [0]:
            for engine in engines:
                for rk in ("none", "host2"):
                    out[f"{name}|solve|{engine}|{b}|{rk}"] = guard(
                        lambda: pl.solve(engine, b, residency=res[rk]))
            out[f"{name}|for_budget|{b}"] = guard(
                lambda: Planner.for_budget(mods, shape, batch, b, xi=xi))
            out[f"{name}|for_budget_host|{b}"] = guard(
                lambda: Planner.for_budget(mods, shape, batch, b, xi=xi,
                                           residency=res["host1"]))
            out[f"{name}|residencize|{b}"] = guard(
                lambda: pl.residencize(pl.solve("twophase", b)))
            gb = b / 2**30
            for rq in (dict(engine="twophase_h", n_rows=8),
                       dict(engine="overlap_h"), dict(n_rows=2),
                       dict(n_rows=3, residency="recompute"), dict()):
                key = ",".join(f"{k}={v}" for k, v in sorted(rq.items()))
                out[f"{name}|resolve|{key}|{b}"] = guard(
                    lambda: pl.resolve(PlanRequest(budget_gb=gb, **rq)))
    return out
'''

#: the child compiles many small programs; one XLA thread keeps it from
#: crowding other test workers, and is no slower
CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

PLAN_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
import numpy as np
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.exec import Planner, PlanRequest, ResidencySpec
from repro.exec.planner import derive_segments, segment_row_capacity
from repro.models.cnn import resnet, vgg

def n_params(init, key):
    tree = jax.eval_shape(lambda k: init(k)[1], key)
    return sum(int(np.prod(l.shape)) for l in jax.tree.leaves(tree))

key = jax.random.PRNGKey(0)
full = (224, 224, 3)
trunks = {
    "vgg_s3_32": (vgg.vgg16_modules(0.125, 3), (32, 32, 3), 2, 0),
    "vgg_reduced": (vgg.vgg16_modules(0.125), (64, 64, 3), 2, 1000),
    "resnet_reduced": (resnet.resnet50_modules(0.125, [1, 1, 1, 1]),
                       (64, 64, 3), 2, 1000),
    "vgg_full": (vgg.vgg16_modules(1.0), full, 32, 12 * n_params(
        lambda k: vgg.init_vgg16(k, full), key)),
    "resnet_full": (resnet.resnet50_modules(1.0), full, 32, 12 * n_params(
        lambda k: resnet.init_resnet50(k, full), key)),
}
ns = dict(Planner=Planner, PlanRequest=PlanRequest,
          ResidencySpec=ResidencySpec, derive_segments=derive_segments,
          segment_row_capacity=segment_row_capacity, trunks=trunks)
exec(open(sys.argv[1]).read(), ns)
json.dump(ns["run"](ns), open(sys.argv[2], "w"))
'''


def _port_trunks():
    from repro_torch.models.cnn import resnet, vgg
    from repro_torch.optim.adamw import tree_leaves

    def xi(init):
        return 12 * sum(t.numel() for t in tree_leaves(
            init(torch.Generator().manual_seed(0))[1]))

    full = (224, 224, 3)
    return {
        "vgg_s3_32": (vgg.vgg16_modules(0.125, 3), (32, 32, 3), 2, 0),
        "vgg_reduced": (vgg.vgg16_modules(0.125), (64, 64, 3), 2, 1000),
        "resnet_reduced": (resnet.resnet50_modules(0.125, [1, 1, 1, 1]),
                           (64, 64, 3), 2, 1000),
        "vgg_full": (vgg.vgg16_modules(1.0), full, 32, xi(
            lambda g: vgg.init_vgg16(g, full, device="meta"))),
        "resnet_full": (resnet.resnet50_modules(1.0), full, 32, xi(
            lambda g: resnet.init_resnet50(g, full, device="meta"))),
    }


@pytest.fixture(scope="module")
def plan_answers(tmp_path_factory):
    """(reference, port) answers to ``PLAN_QUERIES``."""
    import json
    import os
    import subprocess
    from repro_torch.exec import ResidencySpec
    from repro_torch.exec.planner import derive_segments, segment_row_capacity

    d = tmp_path_factory.mktemp("ref_planner")
    (d / "queries.py").write_text(PLAN_QUERIES)
    root = pathlib.Path(__file__).resolve().parents[1]
    child = subprocess.Popen(
        [sys.executable, "-c", PLAN_CHILD, str(d / "queries.py"),
         str(d / "ref.json")], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:  # the port answers while the child works
        ns = dict(Planner=Planner, PlanRequest=PlanRequest,
                  ResidencySpec=ResidencySpec,
                  derive_segments=derive_segments,
                  segment_row_capacity=segment_row_capacity,
                  trunks=_port_trunks())
        exec(PLAN_QUERIES, ns)
        port = json.loads(json.dumps(ns["run"](ns)))
        _, err = child.communicate(timeout=600)
    finally:
        child.kill()
        child.wait()
    assert child.returncode == 0, err[-4000:]
    return json.load(open(d / "ref.json")), port


KINDS = ["xi", "cap", "seg", "est", "plan", "solve", "for_budget",
         "for_budget_host", "residencize", "resolve"]


@pytest.mark.parametrize("kind", KINDS)
def test_planner_answers_equal_reference(plan_answers, kind):
    ref, port = plan_answers
    keys = sorted(k for k in ref if k.split("|")[1] == kind)
    assert keys and keys == sorted(k for k in port
                                   if k.split("|")[1] == kind)
    bad = [k for k in keys if ref[k] != port[k]]
    assert not bad, [(k, ref[k], port[k]) for k in bad[:3]]


def _full(arch):
    from repro_torch.models.cnn import resnet, vgg
    from repro_torch.optim.adamw import tree_leaves
    init = vgg.init_vgg16 if arch == "vgg16" else resnet.init_resnet50
    mods, p = init(torch.Generator().manual_seed(0), (224, 224, 3),
                   device="meta")
    xi = 12 * sum(t.numel() for t in tree_leaves(p))
    return Planner(mods, (224, 224, 3), 32, xi=xi), mods, xi


@pytest.mark.parametrize("arch,est,segments,host", [
    ("vgg16", 1115531128, ((0, 6, 8), (6, 11, 8), (11, 16, 8), (16, 21, 8),
                           (21, 26, 7), (26, 31, 3)), 1087145848),
    ("resnet50", 657321336, ((0, 5, 8), (5, 10, 7), (10, 15, 3),
                             (15, 20, 1)), 611847544),
])
def test_full_width_config_requests(arch, est, segments, host):
    """The full configs' own request (twophase_h N=8 under 24 GB) at 224²,
    batch 32, xi = 3 * 4 * n_params, as the reference resolves it."""
    import importlib
    from repro_torch.exec import ResidencySpec
    planner, _, _ = _full(arch)
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    plan = planner.resolve(cfg.plan)
    assert (plan.engine, plan.n_rows, plan.est_bytes, plan.segments) \
        == ("twophase_h", 8, est, segments)
    for policy in ("host", "recompute"):
        assert planner.plan("twophase_h", 8, residency=ResidencySpec(
            default=policy)).est_bytes == host


@pytest.mark.parametrize("arch,rows", [
    ("vgg16", [("base", 1, 3840690040), ("ckp", 1, 2604353400),
               ("overlap", 4, 2812569464), ("twophase", 2, 2043471736),
               ("overlap_h", 8, 1110112120)]),
    ("resnet50", [("base", 1, 1323429240), ("ckp", 1, 899542392),
                  ("overlap", 4, 1296133496), ("overlap_h", 8, 621291384)]),
])
def test_full_width_estimates(arch, rows):
    planner, _, _ = _full(arch)
    for engine, n, est in rows:
        assert planner.plan(engine, n).est_bytes == est, engine


@pytest.mark.parametrize("arch,grid", [
    ("vgg16", [(4.0, "base", 1, True), (2.0, "twophase", 2, True),
               (1.5, "twophase_h", 3, True), (1.2, "twophase_h", 5, True),
               (1.0, "twophase_h", 11, True),
               (0.8, "overlap_h", 64, False)]),
    ("resnet50", [(1.2, "overlap", 7, True), (1.0, "twophase_h", 1, True),
                  (0.8, "twophase_h", 2, True)]),
])
def test_full_width_for_budget(arch, grid):
    planner, mods, xi = _full(arch)
    for gb, engine, n, feasible in grid:
        plan = Planner.for_budget(mods, (224, 224, 3), 32, int(gb * 2**30),
                                  xi=xi)
        assert (plan.engine, plan.n_rows, plan.feasible) \
            == (engine, n, feasible), gb
    # 0.8 GiB: the best infeasible plan is 880.5 MiB
    if arch == "vgg16":
        assert round(plan.est_bytes / 2**20, 1) == 880.5


@pytest.mark.parametrize("width,stages,image", TRUNKS)
@pytest.mark.parametrize("engine", ["base", "ckp", "overlap", "twophase",
                                    "overlap_h", "twophase_h"])
@pytest.mark.parametrize("residency", [None, "host", "recompute"])
def test_estimate_terms_sum_to_the_estimate(width, stages, image, engine,
                                            residency):
    """``estimate_terms`` splits a plan's per-device estimate into the
    terms the Planner adds; they sum to it for every CNN engine, N and
    residency, and ``sd_volume`` prices every 2PS block's caches."""
    from repro_torch.exec import ResidencySpec
    mods = vgg16_modules(width, stages)
    res = ResidencySpec(default=residency) if residency else None
    pl = Planner(mods, (image, image, 3), 2, xi=12345)
    for n in (1, 2, 3):
        try:
            plan = pl.plan(engine, n, residency=res)
        except ValueError:  # N past this engine's bound at this size
            continue
        terms = pl.estimate_terms(plan)
        assert all(isinstance(v, int) and v >= 0 for v in terms.values())
        assert terms["xi"] == 12345
        assert sum(terms.values()) == plan.est_bytes_per_device, terms
        sd = pl.sd_volume(plan)
        if engine not in ("twophase", "twophase_h"):
            assert sd is None
            continue
        blocks = plan.segments or ((0, len(mods), n),)
        shapes = pt_rp.shape_chain(mods, (image, image, 3))
        assert sd["sd_bytes"] == sum(
            pt_rp.twophase_cache_bytes(mods[a:b], shapes[a], 2, bn)
            for a, b, bn in blocks)
        assert 0 <= sd["input_level_bytes"] <= sd["sd_bytes"]


def test_estimate_terms_of_kernel_and_pinned_plans():
    """A CUDA alternate is priced as the engine it replaced; the terms
    carry the hybrids' segment prefix and reject a sequence engine."""
    mods = vgg16_modules(0.125, 3)
    pl = Planner(mods, (32, 32, 3), 2, xi=7)
    for engine in ("base", "overlap"):
        plan = pl.kernelize(pl.plan(engine, 2), "cuda")
        assert plan.engine == "overlap_cuda"
        assert sum(pl.estimate_terms(plan).values()) \
            == plan.est_bytes_per_device
    assert set(pl.estimate_terms(pl.plan("twophase_h", 2))) == {
        "checkpoints", "segment.bp_rows", "segment.sd_caches", "xi"}
    assert set(pl.estimate_terms(pl.plan("base"))) == {"feature_maps", "xi"}
    with pytest.raises(ValueError, match="not a CNN engine"):
        pl.estimate_terms(ExecutionPlan.explicit("seq_swa_cuda", 2))
