"""Per-site backend degradation ladder for the serving control plane
(PyTorch port of the reference's ``serve/degrade.py``).

Rungs, fastest first::

    cuda_fused -> cuda -> gather -> float

``cuda_fused`` serves the per-layer sites out of the multi-site
super-slab through kernel K4, ``cuda`` each site through K1 (stacked) or
K2 (per plan), ``gather`` through the plain PyTorch form.  Every rung
above ``float`` serves the *same* compressed tables and computes the same
bits, so demoting a site on a kernel fault changes no served token;
only when every LUT rung of a site is unhealthy does the exact float
activation (the last resort, which changes values but keeps serving)
take over.

The ladder

* keeps one memoized table build per rung and composes mixed per-site
  tables: healthy sites ride the top rung, demoted sites a lower one,
  through per-entry ``"backend"`` keys (``nn/mlp.py::site_tables``);
* attributes faults by probing each site's entry directly, and holds the
  kernel rungs bit for bit against the gather rung on a fixed probe
  vector, which catches silently corrupted packed slabs, not only raising
  kernels;
* re-probes demoted sites one rung up with exponential backoff and
  promotes them back one rung per healthy probe;
* reports the active rung per site (:meth:`DegradationLadder.status`) and
  its demotion and promotion counts.

It is a batcher *supervisor* (``on_tick`` / ``on_fault``, see
:class:`~repro_torch.serve.batching.ContinuousBatcher`); chain it behind
a :class:`~repro_torch.serve.reload.PlanReloader` with
:class:`CompositeSupervisor`.  Every demotion or promotion swaps the
batcher's tables, and the swap captures the decode step again on its
next call; a fault raised while a step is captured leaves no graph
behind (:meth:`~repro_torch.serve.graphs.CapturedStep.capture`).  Every
demotion and promotion lands in the telemetry as the reference's
``ladder_demotions_total`` / ``ladder_promotions_total{site}`` counters
and ``ladder_demote`` / ``ladder_promote`` events (:mod:`repro_torch.obs`);
the ladder decides on its own probes, never on a telemetry counter.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.device import resolve_device

RUNGS = ("cuda_fused", "cuda", "gather", "float")


@dataclasses.dataclass
class SiteHealth:
    rung: int                       # index into RUNGS (lower = faster)
    demotions: int = 0
    promotions: int = 0
    backoff: int = 0                # current re-probe backoff (ticks)
    next_probe: int = 0             # tick at which to re-probe one rung up
    last_fault: str | None = None


class CompositeSupervisor:
    """Chain batcher supervisors: every ``on_tick`` runs; the first
    ``on_fault`` that handles a fault wins.  Order is priority: put the
    :class:`~repro_torch.serve.reload.PlanReloader` before the ladder so a
    probation rollback outranks a backend demotion."""

    def __init__(self, *subs):
        self.subs = [s for s in subs if s is not None]

    def on_tick(self, batcher) -> None:
        for s in self.subs:
            if hasattr(s, "on_tick"):
                s.on_tick(batcher)

    def on_fault(self, batcher, exc) -> bool:
        for s in self.subs:
            if hasattr(s, "on_fault") and s.on_fault(batcher, exc):
                return True
        return False


class DegradationLadder:
    """Health state machine over the serving backends, per site.

    ``source`` is anything with ``.sites``, ``fused_available`` and
    ``tables_for_model`` (:class:`~repro_torch.serve.plans.ServingPlans`
    or a loaded :class:`~repro_torch.tune.artifact.TunedPlan`); the rungs'
    tables are built on ``device`` (the card unless named).
    :meth:`rebind` swaps the source on a hot reload, resetting every site
    to the top rung.
    """

    def __init__(self, source, *, plan_exec: str | None = None,
                 top_rung: str | None = None, backoff_ticks: int = 2,
                 max_backoff_ticks: int = 64, revalidate_every: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.backoff_ticks = backoff_ticks
        self.max_backoff_ticks = max_backoff_ticks
        self.revalidate_every = revalidate_every
        self.demotions = 0
        self.promotions = 0
        self.faults: list[tuple[str, str, str]] = []  # (site, rung, error)
        self._tick = 0
        self.rebind(source, plan_exec=plan_exec, top_rung=top_rung)

    def rebind(self, source, *, plan_exec: str | None = None,
               top_rung: str | None = None) -> None:
        """Point the ladder at a (new) plan source: rung caches are
        dropped and every site returns to the top rung (a reloaded plan
        earns its demotions on its own faults)."""
        self.source = source
        self.plan_exec = plan_exec or getattr(source, "plan_exec", "stacked")
        if top_rung is None:
            best = ("cuda_fused" if source.fused_available(self.plan_exec)
                    else "cuda")
            # a rebind (hot reload) keeps the configured top rung (a
            # gather-serving ladder must not promote itself to the
            # kernels) unless the new source cannot serve it (no fused
            # form)
            top_rung = (RUNGS[max(self.top, RUNGS.index(best))]
                        if hasattr(self, "top") else best)
        if top_rung not in RUNGS:
            raise ValueError(f"unknown ladder rung {top_rung!r} "
                             f"(expected one of {RUNGS})")
        self.top = RUNGS.index(top_rung)
        self.health = {site: SiteHealth(rung=self.top)
                       for site in source.sites}
        self._rung_cache: dict[str, dict] = {}
        self._composed: tuple | None = None

    # -- rung table builds --------------------------------------------------
    def rung_tables(self, rung: str) -> dict:
        """The full serving-tables dict of one rung, memoized: raw int32
        on the gather rung, packed slabs on the kernel rungs (the
        multi-site super-slab on ``cuda_fused``)."""
        tables = self._rung_cache.get(rung)
        if tables is None:
            kw = {"plan_exec": self.plan_exec, "device": self.device}
            if rung == "cuda_fused":
                kw.update(backend="cuda", kernel="fused")
            elif rung in ("cuda", "gather"):
                kw.update(backend=rung)
            else:
                raise ValueError(f"no tables on the {rung!r} rung")
            tables = self.source.tables_for_model(**kw)
            self._rung_cache[rung] = tables
        return tables

    def set_rung_tables(self, rung: str, tables: dict) -> None:
        """Replace one rung's cached tables: the fault-injection hook
        (:func:`repro_torch.serve.faults.corrupt_rung`)."""
        self._rung_cache[rung] = tables
        self._composed = None

    # -- composition --------------------------------------------------------
    def rung_for(self, site: str) -> str:
        return RUNGS[self.health[site].rung]

    def status(self) -> dict[str, str]:
        """Active rung per site: the control plane's health surface."""
        return {site: self.rung_for(site) for site in self.health}

    def tables(self) -> dict | None:
        """Compose the served ``lut_tables`` from each site's active rung:
        every entry carries its rung's ``"backend"`` key, float-rung sites
        are omitted (the exact activation runs), and an all-float ladder
        serves no tables at all."""
        if self._composed is not None:
            return self._composed[0]
        sites_out: dict[str, dict] = {}
        multi = None
        any_cuda = False
        for site, h in self.health.items():
            rung = RUNGS[h.rung]
            if rung == "float":
                continue
            src = self.rung_tables(rung)
            entry = dict(src["sites"][site])
            entry["backend"] = "gather" if rung == "gather" else "cuda"
            if "multi" in entry:
                multi = src["multi"]
            any_cuda = any_cuda or entry["backend"] == "cuda"
            sites_out[site] = entry
        if not sites_out:
            result = None
        else:
            result = {
                "backend": "cuda" if any_cuda else "gather",
                "kernel": "fused" if multi is not None else "isolated",
                "sites": sites_out,
            }
            if multi is not None:
                result["multi"] = multi
        self._composed = (result,)
        return result

    # -- probing ------------------------------------------------------------
    def _evaluate(self, tables: dict, site: str) -> torch.Tensor:
        """One site's entry at layer 0 on a fixed float32 probe vector."""
        from repro_torch.nn.mlp import apply_lut_act, site_tables

        entry = tables["sites"][site]
        per_layer = any(k in entry for k in ("stacked", "layers", "multi"))
        tab = site_tables(tables, site, 0 if per_layer else None)
        x = torch.linspace(-4.0, 4.0, 256, dtype=torch.float32,
                           device=self.device)
        return apply_lut_act(x, tab, tables["backend"])

    def _probe(self, site: str, rung_idx: int) -> str | None:
        """Evaluate one site's entry at one rung on the probe vector.
        Returns ``None`` when healthy, else the failure description.  The
        kernel rungs must also equal the gather rung bit for bit: the
        port's kernels compute the gather form's bits, so the check is
        exact (the reference allows an ulp, ``rtol = atol = 1e-5``,
        because XLA and Pallas may reassociate its float dequantization)."""
        rung = RUNGS[rung_idx]
        if rung == "float":
            return None
        try:
            y = self._evaluate(self.rung_tables(rung), site)
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        if not bool(torch.isfinite(y).all()):
            return "non-finite probe output"
        if rung != "gather":
            try:
                ref = self._evaluate(self.rung_tables("gather"), site)
            except Exception as e:
                return f"gather reference unavailable ({e})"
            if not torch.equal(y, ref):
                return (f"validation vs gather failed (max abs diff "
                        f"{float((y - ref).abs().max()):.3g})")
        return None

    # -- state machine ------------------------------------------------------
    def handle_fault(self, exc=None) -> bool:
        """Attribute a serving fault: probe every site at its active rung
        and demote failures to the highest healthy lower rung.  Returns
        True when any site moved (the composed tables changed)."""
        changed = False
        for site, h in self.health.items():
            err = self._probe(site, h.rung)
            if err is None:
                continue
            rung = h.rung
            while rung < len(RUNGS) - 1:
                rung += 1
                if self._probe(site, rung) is None:
                    break
            self.faults.append((site, RUNGS[h.rung], err))
            obs.count("ladder_demotions_total", site=site)
            obs.event("ladder_demote", site=site, from_rung=RUNGS[h.rung],
                      to_rung=RUNGS[rung], error=err)
            h.last_fault = err
            h.rung = rung
            h.demotions += 1
            h.backoff = self.backoff_ticks
            h.next_probe = self._tick + h.backoff
            self.demotions += 1
            changed = True
        if changed:
            self._composed = None
        return changed

    def tick(self) -> bool:
        """Advance one scheduler tick: re-probe demoted sites past their
        backoff (promote one rung per healthy probe, double the backoff
        on failure) and run the periodic revalidation sweep.  Returns
        True when the composed tables changed."""
        self._tick += 1
        changed = False
        for site, h in self.health.items():
            if h.rung > self.top and self._tick >= h.next_probe:
                if self._probe(site, h.rung - 1) is None:
                    obs.count("ladder_promotions_total", site=site)
                    obs.event("ladder_promote", site=site,
                              from_rung=RUNGS[h.rung],
                              to_rung=RUNGS[h.rung - 1])
                    h.rung -= 1
                    h.promotions += 1
                    self.promotions += 1
                    h.backoff = self.backoff_ticks
                    h.next_probe = self._tick + 1   # keep climbing
                    changed = True
                else:
                    h.backoff = min(
                        max(h.backoff, self.backoff_ticks) * 2,
                        self.max_backoff_ticks)
                    h.next_probe = self._tick + h.backoff
        if changed:
            self._composed = None
        if (self.revalidate_every
                and self._tick % self.revalidate_every == 0):
            if self.handle_fault():
                changed = True
        return changed

    # -- batcher supervisor protocol ---------------------------------------
    def on_tick(self, batcher) -> None:
        if self.tick():
            batcher.swap_tables(self.tables())

    def on_fault(self, batcher, exc) -> bool:
        if self.handle_fault(exc):
            batcher.swap_tables(self.tables())
            return True
        return False
