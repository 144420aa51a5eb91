"""ServeEngine: the compute half of the serving subsystem (counterpart of
``repro.serve.engine``), for the whole config zoo through two model paths
— :mod:`repro_torch.models.lm.model` for the decoder-only families (dense,
MoE, SSM, hybrid, VLM) and :mod:`repro_torch.models.lm.encdec` for the
encoder-decoder — with one surface:

* ``prefill(request)`` — batch=1 full-prompt forward producing the slot
  cache and first-token logits.  The prompt is *budget-chunked*: a
  sequence-axis :class:`ExecutionPlan` from ``Planner.for_model`` picks the
  row-chunk count that fits the prefill activation budget (Eq. 7 along the
  token axis), so a long prompt never blows the budget a decode batch is
  already using.  As in the reference, the prefill runs the config's own
  layers with that chunk count and enters no plan: local attention takes
  the halo chunk loop, and no kernel of ``repro_torch.kernels`` runs here.
  A VLM request carries its patch embeddings and an enc-dec request its
  frames (``Request.features``); the frames must be the pool's
  ``enc_len`` long, since the cross-attention caches are fixed-shape.
* ``decode_step(tokens, caches)`` — one batched decode step over the
  pool's slots (the continuous batch); the caches are updated in place.
* ``sample(logits_row, request, step)`` — greedy / temperature / top-k.
  The reference draws from ``fold_in(PRNGKey(seed), step)``; threefry is
  not reproducible without JAX, so the port draws from a
  ``torch.Generator`` on the logits' device seeded by a fixed mix of
  (request seed, step) (:func:`sample_seed`).  What the reference
  guarantees holds: tokens depend only on (seed, step), never on slot
  placement or batch composition.  Greedy tokens equal the reference's.

Everything runs under ``torch.no_grad``.  Registered as the ``serve_pool``
engine (kind="serve"): ``build_apply((params, cfg), plan)`` returns a
ServeEngine on the parameters' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.exec.plan import ExecutionPlan, ResidencySpec
from repro_torch.exec.planner import Planner
from repro_torch.exec.registry import register_engine
from repro_torch.models.lm import model as LM
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve.request import Request

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, step: int) -> int:
    """The generator seed of token ``step`` of a request seeded ``seed``:
    a fixed 64-bit mix (splitmix64's finaliser over ``seed * 2**32 +
    step``), so nearby (seed, step) pairs draw unrelated streams."""
    z = ((int(seed) << 32) + int(step) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _sample_token(logits, gen: torch.Generator, temperature: float,
                  top_k: int):
    """(token, all_finite) from a (V,) logits row.  fp32 math; top-k masks
    below the k-th largest logit, then a Gumbel-max categorical draw
    (``jax.random.categorical``'s method)."""
    lg = logits.float()
    ok = torch.isfinite(lg).all()
    if top_k > 0:
        kth = torch.topk(lg, top_k).values[-1]
        lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    u = torch.rand(lg.shape, generator=gen, device=lg.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(lg / temperature + gumbel), ok


def _argmax_token(logits):
    lg = logits.float()
    return torch.argmax(lg), torch.isfinite(lg).all()


class ServeEngine:
    """Holds the parameters and the config of one model; runs on the
    parameters' device."""

    def __init__(self, params, cfg, plan: ExecutionPlan,
                 prefill_budget: int = 0, residency: str = ""):
        if plan.engine != "serve_pool":
            raise ValueError(f"ServeEngine needs a serve_pool plan, got "
                             f"{plan.engine!r}")
        if plan.mesh is not None and plan.mesh.n_devices > 1:
            raise NotImplementedError(
                f"sharded serving (mesh={plan.mesh.describe()}) is not "
                f"ported yet (it waits for the sharding slice's serve pools, "
                f"ROADMAP.md queue 1, item 2)")
        self._fns = LM.family_fns(cfg)
        self.params = params
        self.cfg = cfg
        self.plan = plan
        self.max_len = int(plan.get("max_len"))
        self.enc_len = int(plan.get("enc_len", 0))
        self.prefill_budget = prefill_budget
        # boundary-cache residency policy recorded on every per-prompt
        # prefill plan (the prefill executes the config's chunking; this
        # is policy bookkeeping, as in the reference)
        self.prefill_residency = residency
        self.device = tree_leaves(params)[0].device

    # ------------------------------------------------------------------
    # prefill (one request, budget-chunked)
    # ------------------------------------------------------------------
    def prefill_plan(self, prompt_len: int) -> ExecutionPlan:
        """Sequence-axis plan for one prompt under the prefill budget
        (carries the prefill residency policy, if any)."""
        return Planner.for_model(
            self.cfg, 1, prompt_len, budget=self.prefill_budget,
            residency=ResidencySpec.parse(self.prefill_residency))

    def _prefill_fn(self, prompt_len: int, n_chunks: int):
        """The prefill of a ``prompt_len`` prompt in ``n_chunks`` row
        chunks: a config copy with the plan's ``row_chunks`` and row
        remat (no compile cache is needed in eager PyTorch)."""
        cfg = self.cfg
        remat = {"none": "rows", "block": "block_rows"}.get(cfg.remat,
                                                            cfg.remat)
        pcfg = dataclasses.replace(cfg, row_chunks=n_chunks, remat=remat)
        prefill = self._fns.prefill
        return lambda p, b: prefill(p, b, pcfg, self.max_len)

    def _prefill_batch(self, req: Request) -> dict:
        tokens = torch.from_numpy(np.asarray(req.prompt[None, :], np.int64))
        batch = {"tokens": tokens.to(self.device)}
        cfg = self.cfg
        if cfg.family == "encdec":
            if req.features is None:
                raise ValueError(f"request {req.rid}: enc-dec serving needs "
                                 f"frame features")
            if req.features.shape[0] != self.enc_len:
                raise ValueError(
                    f"request {req.rid}: frames length "
                    f"{req.features.shape[0]} != pool enc_len {self.enc_len}"
                    f" (cross-attention caches are fixed-shape per pool)")
            batch["frames"] = self._features(req)
        elif cfg.frontend == "vision":
            if req.features is None:
                raise ValueError(f"request {req.rid}: VLM serving needs "
                                 f"patch embeddings")
            batch["patch_embeds"] = self._features(req)
        return batch

    def _features(self, req: Request):
        return torch.from_numpy(np.asarray(req.features[None], np.float32)) \
            .to(self.device)

    @torch.no_grad()
    def prefill(self, req: Request):
        """Run one request's prompt.  Returns (last-token logits (V,),
        batch=1 cache tree, n_chunks the plan picked)."""
        total = req.prompt_len + req.max_new_tokens
        if self.cfg.frontend == "vision":
            total += self.cfg.n_frontend_tokens
        if total > self.max_len:
            raise ValueError(f"request {req.rid}: prompt+gen {total} "
                             f"exceeds pool max_len {self.max_len}")
        plan = self.prefill_plan(req.prompt_len)
        fn = self._prefill_fn(req.prompt_len, plan.n_rows)
        logits, cache = fn(self.params, self._prefill_batch(req))
        return logits[0, -1], cache, plan.n_rows

    # ------------------------------------------------------------------
    # batched decode over the pool
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, tokens: np.ndarray, caches):
        """One decode step over the given slots.  tokens: (n_slots,) ints
        (the last token per slot; value irrelevant for free slots).
        Returns (logits (n_slots, V), caches updated in place)."""
        t = torch.from_numpy(np.asarray(tokens, np.int64)[:, None])
        logits, caches = self._fns.decode(self.params, t.to(self.device),
                                          caches, self.cfg)
        return logits[:, -1], caches

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample(self, logits_row, req: Request, step: int) -> int:
        """Token ``step`` for ``req`` from its logits row.  Pure function
        of (row values, request seed, step) — batching-invariant."""
        if req.temperature <= 0.0:
            tok, ok = _argmax_token(logits_row)
        else:
            gen = torch.Generator(device=logits_row.device)
            gen.manual_seed(sample_seed(req.seed, step))
            tok, ok = _sample_token(logits_row, gen, float(req.temperature),
                                    req.top_k)
        if not bool(ok):
            # argmax/categorical over a NaN row would silently emit a
            # token — surface numeric breakage at the request it hit
            raise FloatingPointError(
                f"non-finite logits for request {req.rid} at step {step}")
        return int(tok)


@register_engine("serve_pool", kind="serve",
                 doc="continuous-batching decode-slot pool "
                     "(repro_torch.serve): modules=(params, cfg), plan "
                     "from Planner.for_serve")
def _build_serve_pool(modules, plan: ExecutionPlan):
    params, cfg = modules
    return ServeEngine(params, cfg, plan)
