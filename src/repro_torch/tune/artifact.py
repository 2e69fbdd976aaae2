"""Tuned-plan artifacts, bit-exact on disk (PyTorch port of the
reference's ``tune/artifact.py``), in its ``repro-tuned-plan/v1`` format,
so either package loads the other's files.

A :class:`TunedPlan` is what ``launch/serve --tuned-plan`` needs to serve
without recapture or recompression: the per-layer plan arrays (int32,
saved exactly), their quantization metas, and the knobs, frontier and
metrics of the tuner that chose them (:func:`tuned_plan_from_outcome`;
empty for plans frozen from a serving run,
:func:`tuned_plan_from_serving`).  The serving forms
(stacked / unrolled, gather / cuda, packed, ``kernel="fused"``) are
rebuilt from the stored entries, so a loaded artifact decodes
token-identically to the plans it was saved from.

One compressed ``.npz`` holds a JSON header plus one array per
``plan:{site}:{layer}:{field}``; writes are atomic and the payload is
content-checksummed (:mod:`repro_torch.ioutil`).  The stored ``backend``
uses the reference's names: the port's ``"cuda"`` is written
``"pallas"`` and read back as ``"cuda"``, so a file from either package
serves on the other's default backend.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.ioutil import (
    ArtifactError,
    load_checked_npz,
    save_checked_npz,
)
from repro_torch.kernels import PlanArrays
from repro_torch.kernels.packing import COMPONENTS as _FIELDS

_FORMAT = "repro-tuned-plan/v1"
_PLAN = "plan:"
# the port's backend names -> the reference's, as stored
_STORED = {"cuda": "pallas", "gather": "gather"}
_LOADED = {v: k for k, v in _STORED.items()}


@dataclasses.dataclass
class TunedPlan:
    """Loaded (or about-to-be-saved) tuned serving plan; ``backend`` in
    the port's names (``"cuda"`` or ``"gather"``)."""

    arch: str                       # cfg.name the plans were tuned for
    family: str
    n_layers: int
    backend: str                    # default backend
    plan_exec: str                  # default execution form
    sites: dict[str, list[dict]]    # site kind -> per-layer entries
    per_layer: dict[str, bool]      # site kind -> one entry per layer?
    knobs: dict                     # chosen knobs per site kind
    frontier: list[dict]            # measured Pareto frontier rows
    metrics: dict                   # parity metrics of the selection
    meta: dict = dataclasses.field(default_factory=dict)

    def tables_for_model(self, backend: str | None = None,
                         plan_exec: str | None = None,
                         packed: bool | None = None,
                         kernel: str | None = None, device=None) -> dict:
        """Rebuild the ``lut_tables`` dict on ``device`` straight from the
        stored entries (no capture, no engine), as
        :meth:`repro_torch.serve.plans.ServingPlans.tables_for_model`
        builds it: packed slabs by default on ``"cuda"``, and
        ``kernel="fused"`` serving the per-layer sites out of one
        multi-site super-slab (stacked execution only)."""
        from repro_torch.serve.plans import BACKENDS, plan_entry
        from repro_torch.serve.stacked import (
            MultiSiteSlabs,
            StackedPlanArrays,
        )

        exec_ = plan_exec or self.plan_exec
        if exec_ not in ("stacked", "unrolled"):
            raise ValueError(
                f"TunedPlan.tables_for_model: unknown plan_exec {exec_!r} "
                f"(expected 'stacked' or 'unrolled')")
        backend = backend or self.backend
        if backend not in BACKENDS:
            raise ValueError(f"TunedPlan.tables_for_model: unknown backend "
                             f"{backend!r} (expected one of {BACKENDS})")
        kernel = kernel or "isolated"
        if kernel not in ("isolated", "fused"):
            raise ValueError(
                f"TunedPlan.tables_for_model: unknown kernel {kernel!r} "
                f"(expected 'isolated' or 'fused')")
        if packed is None:
            packed = backend == "cuda"
        if packed and backend != "cuda":
            raise ValueError("TunedPlan.tables_for_model: packed slabs are "
                             "for the cuda backend")
        if kernel == "fused" and exec_ != "stacked":
            raise ValueError("TunedPlan.tables_for_model: kernel='fused' "
                             "needs plan_exec='stacked'")
        dev = resolve_device(device)

        def one(e: dict) -> dict:
            return plan_entry(dict(e["meta"]), e["arrays"], packed=packed,
                              device=dev)

        sites: dict[str, dict] = {}
        stacks: dict[str, StackedPlanArrays] = {}
        for site, entries in self.sites.items():
            if not self.per_layer.get(site, True):
                sites[site] = one(entries[0])
            elif exec_ == "stacked":
                st = StackedPlanArrays.from_entries(entries)
                stacks[site] = st
                sites[site] = {"stacked": st.entry(packed=packed,
                                                   device=dev)}
            else:
                sites[site] = {"layers": [one(e) for e in entries]}
        tables = {"backend": backend, "kernel": kernel, "sites": sites}
        if kernel == "fused" and stacks:
            tables["multi"] = MultiSiteSlabs.from_stacks(stacks).entry(
                device=dev)
            for site in stacks:
                tables["sites"][site] = {"multi": site}
        return tables

    def patched_config(self, cfg: ArchConfig) -> ArchConfig:
        if cfg.name != self.arch:
            raise ValueError(
                f"TunedPlan: artifact was tuned for arch {self.arch!r} "
                f"but the launcher config is {cfg.name!r} — tuned plans "
                f"are bound to the model they were measured on")
        if cfg.n_layers != self.n_layers:
            raise ValueError(
                f"TunedPlan: artifact has {self.n_layers} layers per "
                f"site, config expects {cfg.n_layers}")
        return dataclasses.replace(cfg, lut_activation=True)

    def fused_available(self, plan_exec: str | None = None) -> bool:
        """True when these plans can serve the multi-site kernel K4
        (stacked execution and at least one per-layer site): the top rung
        of the serving degradation ladder."""
        exec_ = plan_exec or self.plan_exec
        return exec_ == "stacked" and any(self.per_layer.values())

    @property
    def total_cost(self) -> int:
        return int(self.meta.get("cost", 0))

    def summary(self) -> str:
        m = self.metrics or {}
        sites = ", ".join(
            f"{k}({len(v)} tables)" for k, v in sorted(self.sites.items()))
        return (f"tuned plan [{self.arch}] {sites}; "
                f"cost {self.meta.get('cost')} P-LUTs "
                f"(default {self.meta.get('default_cost')}); "
                f"top-1 drop {m.get('top1_drop', float('nan')):.4f} "
                f"(budget {self.meta.get('budget')}); "
                f"{len(self.frontier)} frontier points")


def _frozen_sites(plans) -> tuple[dict, dict]:
    """``(sites, per_layer)`` of built serving plans: each site kind's
    per-layer entries (meta and lane-padded int32 component arrays, the
    exact arrays the plans serve)."""
    sites: dict[str, list[dict]] = {}
    per_layer: dict[str, bool] = {}
    for kind, sp in plans.sites.items():
        entries = []
        for lut in sp.luts:
            host = PlanArrays.host_arrays(lut.plan)[0]
            entries.append({
                "meta": dict(lut.meta()),
                "arrays": {f: np.asarray(host[f], dtype=np.int32)
                           for f in _FIELDS},
            })
        sites[kind] = entries
        per_layer[kind] = sp.per_layer
    return sites, per_layer


def tuned_plan_from_outcome(cfg: ArchConfig, outcome,
                            extra_meta: dict | None = None) -> TunedPlan:
    """Freeze a :class:`~repro_torch.tune.sweep.TuneOutcome` into an
    artifact: its final plans, the chosen knobs per site kind, the
    measured frontier and the selection's parity metrics."""
    sites, per_layer = _frozen_sites(outcome.plans)
    knobs = {k: {**p.to_dict(), "label": p.label()}
             for k, p in outcome.assignment.items()}
    meta = {
        "budget": outcome.budget,
        "budget_met": outcome.budget_met,
        "cost": outcome.cost,
        "default_cost": outcome.default.cost if outcome.default.ok else None,
        "default_table_bytes": (outcome.default.table_bytes
                                if outcome.default.ok else None),
        "table_bytes": outcome.plans.table_bytes(),
        "greedy_evals": outcome.greedy.get("evals", 0),
        **(extra_meta or {}),
    }
    return TunedPlan(
        arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
        backend=outcome.plans.backend, plan_exec=outcome.plans.plan_exec,
        sites=sites, per_layer=per_layer, knobs=knobs,
        frontier=[r.to_dict() for r in outcome.frontier],
        metrics=outcome.metrics.to_dict(), meta=meta)


def tuned_plan_from_serving(cfg: ArchConfig, plans,
                            extra_meta: dict | None = None) -> TunedPlan:
    """Freeze built :class:`~repro_torch.serve.plans.ServingPlans` into an
    artifact without an autotune sweep (``launch/serve --save-plan``).
    The stored entries are the exact arrays the plans serve, so a hot
    reload of a frozen plan passes the parity gate trivially."""
    sites, per_layer = _frozen_sites(plans)
    meta = {"cost": plans.total_cost, "source": "serving_plans",
            "calib": plans.calib, **(extra_meta or {})}
    return TunedPlan(
        arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
        backend=plans.backend, plan_exec=plans.plan_exec,
        sites=sites, per_layer=per_layer, knobs={}, frontier=[],
        metrics={}, meta=meta)


def save_tuned_plan(path: str, tp: TunedPlan) -> str:
    """Write ``tp`` to ``path`` (``.npz`` appended if missing)."""
    if tp.backend not in _STORED:
        raise ValueError(f"save_tuned_plan: unknown backend {tp.backend!r} "
                         f"(expected one of {tuple(_STORED)})")
    header = {
        "format": _FORMAT,
        "arch": tp.arch,
        "family": tp.family,
        "n_layers": tp.n_layers,
        "backend": _STORED[tp.backend],
        "plan_exec": tp.plan_exec,
        "per_layer": tp.per_layer,
        "knobs": tp.knobs,
        "frontier": tp.frontier,
        "metrics": tp.metrics,
        "meta": tp.meta,
        "site_metas": {site: [e["meta"] for e in entries]
                       for site, entries in tp.sites.items()},
    }
    payload: dict[str, np.ndarray] = {}
    for site, entries in tp.sites.items():
        for layer, e in enumerate(entries):
            for field in _FIELDS:
                payload[f"{_PLAN}{site}:{layer}:{field}"] = np.asarray(
                    e["arrays"][field], dtype=np.int32)
    return save_checked_npz(path, header, payload, kind="tuned-plan")


def load_tuned_plan(path: str) -> TunedPlan:
    """Read a :func:`save_tuned_plan` artifact (of either package) back,
    bit-exactly."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    header, data = load_checked_npz(path, kind="tuned-plan")
    if header.get("format") != _FORMAT:
        raise ArtifactError(
            f"{path}: unknown tuned-plan format "
            f"{header.get('format')!r} (expected {_FORMAT!r})")
    if header.get("backend") not in _LOADED:
        raise ArtifactError(
            f"{path}: unknown tuned-plan backend {header.get('backend')!r} "
            f"(expected one of {tuple(_LOADED)})")
    sites: dict[str, list[dict]] = {}
    for site, metas in header["site_metas"].items():
        entries = []
        for layer, meta in enumerate(metas):
            entries.append({
                "meta": dict(meta),
                "arrays": {
                    f: np.asarray(data[f"{_PLAN}{site}:{layer}:{f}"],
                                  dtype=np.int32)
                    for f in _FIELDS},
            })
        sites[site] = entries
    return TunedPlan(
        arch=header["arch"], family=header["family"],
        n_layers=header["n_layers"], backend=_LOADED[header["backend"]],
        plan_exec=header["plan_exec"], sites=sites,
        per_layer=header.get("per_layer", {}),
        knobs=header.get("knobs", {}),
        frontier=header.get("frontier", []),
        metrics=header.get("metrics", {}),
        meta=header.get("meta", {}))
