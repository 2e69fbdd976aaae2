"""Compressed-serving plans: network CompressReport -> decode-ready tables
(PyTorch port of the reference's ``serve/plans.py``).

1. **Site enumeration** — every activation site of the architecture is
   tabulated and calibration-quantized into a
   :class:`~repro_torch.core.TableSpec` per (layer, site): with a shared
   raw calibration sample every site gets the same care mask (the engine's
   dedupe collapses the layers into one plan per site kind); with a
   per-site :class:`~repro_torch.calib.CalibrationSet` every ``(layer,
   site)`` gets its own care mask and output quantization.
2. **Dedupe + compression** — the specs go through
   :func:`~repro_torch.core.engine.compress_network_report`.
3. **Materialization** — winning plans become the ``lut_tables`` dict that
   :func:`repro_torch.serve.decode.prefill`/``decode_step`` consume:
   per-plan entries (shared), ``{"layers": [...]}`` (``plan_exec=
   "unrolled"``) or padded ``(L, …)`` stacks (``"stacked"``, default), as
   raw int32 for the ``"gather"`` backend and bit-packed words for the
   ``"cuda"`` kernels, plus the multi-site super-slab for
   ``kernel="fused"``.

The host-side arrays are byte-identical to the reference's for the same
plans; the two backends give the same tokens, and under a mesh the sharded
program the single-device one's (:func:`verify_backend_equivalence`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import sites as site_registry
from repro_torch.calib import CalibrationSet
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    CompressConfig,
    CompressReport,
    PlanCache,
    compress_network_report,
)
from repro_torch.core.table import TableSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import PlanArrays
from repro_torch.kernels.lut_act import entry_plan_record
from repro_torch.kernels.packing import pack_component_dict
from repro_torch.nn.lut_act import (
    LUTActivation,
    activation_table,
    lut_activation_from_plan,
)

# Engine search space for serving tables (nn.lut_act.build_lut_activation).
DEFAULT_COMPRESS = dict(exiguity=250, m_candidates=(8, 16, 32, 64),
                        lb_candidates=(0, 1, 2, 3))

# Families whose layer loops serve per-layer tables (every family the port
# serves).
PER_LAYER_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")

BACKENDS = ("gather", "cuda")


def activation_sites(cfg: ArchConfig) -> list[tuple[str, str]]:
    """``(site, fn)`` kinds for one architecture config, in registry order:
    the table keys the nn layer resolves (``nn/mlp.py::site_tables``), as
    :func:`repro_torch.sites.active_sites` selects them (family, each
    spec's gate, the config's ``lut_sites`` scope)."""
    return [(spec.key, spec.fn_name(cfg))
            for spec in site_registry.active_sites(cfg)]


def plan_entry(meta: dict, arrays: dict, *, packed: bool, device) -> dict:
    """One plan's site entry ``{"meta", "arrays"}`` from its meta and its
    padded host component arrays (:meth:`PlanArrays.host_arrays`), as
    tensors on ``device``: bit-packed with the unpack parameters in
    ``meta["pack"]`` where ``packed``, and off the CPU with the LUT
    kernels' launch record of its tensors (``"k1_record"``)."""
    dev = resolve_device(device)
    if packed:
        arrays, pack = pack_component_dict(arrays)
        meta = dict(meta, pack=pack)
    out = {"meta": meta,
           "arrays": {c: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for c, a in arrays.items()}}
    if dev.type != "cpu":
        out["k1_record"] = entry_plan_record(out)
    return out


@dataclasses.dataclass
class SitePlan:
    """One site kind's served table(s): one shared entry, or one per layer
    (``per_layer=True``, per-site calibration)."""

    site: str
    act: str
    luts: list[LUTActivation]
    n_sites: int          # how many per-layer sites this kind covers
    per_layer: bool = False

    @property
    def lut(self) -> LUTActivation:
        return self.luts[0]

    @property
    def cost(self) -> int:
        """Total P-LUT cost of every distinct table served for this kind."""
        return sum(l.plan.plut_cost() for l in self.luts)

    @property
    def dontcare_frac(self) -> float:
        return float(np.mean([l.dontcare_frac for l in self.luts]))

    def entry(self, form: str = "stacked", packed: bool = False,
              device=None) -> dict:
        """The site entry the nn layer consumes, as tensors on ``device``:
        ``{"meta", "arrays"}`` (shared), ``{"layers": [...]}`` (per layer,
        unrolled) or ``{"stacked": {...}}`` (per layer, ``(L, …)``
        stacks), off the CPU each with the LUT kernels' launch record of
        its tensors (``"k1_record"``).  Memoized per ``(form, packed,
        device)``."""
        dev = resolve_device(device)
        key = (form, packed, str(dev))
        cache = self.__dict__.setdefault("_entry_cache", {})
        if key in cache:
            return cache[key]

        def one(lut: LUTActivation) -> dict:
            return plan_entry(lut.meta(), PlanArrays.host_arrays(lut.plan)[0],
                              packed=packed, device=dev)
        if not self.per_layer:
            out = one(self.lut)
        elif form == "stacked":
            out = {"stacked": self.stacked().entry(packed=packed,
                                                   device=dev)}
        elif form == "layers":
            out = {"layers": [one(l) for l in self.luts]}
        else:
            raise ValueError(
                f"SitePlan.entry: unknown form {form!r} "
                f"(expected 'stacked' or 'layers')")
        cache[key] = out
        return out

    def stacked(self):
        """This site's :class:`~repro_torch.serve.stacked.
        StackedPlanArrays` (per-layer plans only), memoized."""
        from .stacked import StackedPlanArrays

        st = self.__dict__.get("_stacked")
        if st is None:
            entries = [{"meta": l.meta(),
                        "arrays": PlanArrays.host_arrays(l.plan)[0]}
                       for l in self.luts]
            st = StackedPlanArrays.from_entries(entries)
            self.__dict__["_stacked"] = st
        return st


@dataclasses.dataclass
class ServingPlans:
    """Compressed-activation tables for one architecture."""

    arch: str
    family: str
    report: CompressReport
    sites: dict[str, SitePlan]
    backend: str = "gather"
    calib: str = "shared"        # "shared" | "per_site"
    plan_exec: str = "stacked"   # "stacked" | "unrolled" (per-layer plans)

    _FORMS = {"stacked": "stacked", "unrolled": "layers"}

    def tables_for_model(self, backend: str | None = None,
                         plan_exec: str | None = None,
                         packed: bool | None = None,
                         kernel: str | None = None, device=None,
                         mesh=None, policy=None) -> dict:
        """The ``lut_tables`` dict threaded through prefill/decode.

        ``packed`` defaults to True exactly on the ``"cuda"`` backend (the
        gather evaluators take raw int32).  ``kernel="fused"`` builds every
        per-layer site family into one bit-packed ``(S, L, n)``
        :class:`~repro_torch.serve.stacked.MultiSiteSlabs` super-slab,
        served by the multi-site kernel K4 (and sliced statically by K3
        under ``cfg.lut_fuse``) on ``"cuda"``, and by their plain versions
        on ``"gather"``; it needs stacked execution and no mesh (the
        single-device fast path).

        With a ``mesh``, the tables come back placed for this rank per
        :mod:`repro_torch.serve.sharded`'s ``policy``: small tables
        replicated, large stacked slabs split by layer over the data axis
        (a collective-free cut; the step gathers them)."""
        exec_ = plan_exec or self.plan_exec
        if exec_ not in self._FORMS:
            raise ValueError(
                f"tables_for_model: unknown plan_exec {exec_!r} "
                f"(expected 'stacked' or 'unrolled')")
        backend = backend or self.backend
        if backend not in BACKENDS:
            raise ValueError(f"tables_for_model: unknown backend "
                             f"{backend!r} (expected one of {BACKENDS})")
        kernel = kernel or "isolated"
        if kernel not in ("isolated", "fused"):
            raise ValueError(
                f"tables_for_model: unknown kernel {kernel!r} "
                f"(expected 'isolated' or 'fused')")
        if packed is None:
            packed = backend == "cuda"
        if packed and backend != "cuda":
            raise ValueError(
                "tables_for_model: packed slabs are for the cuda backend — "
                "the gather evaluators consume raw int32 arrays")
        if kernel == "fused" and exec_ != "stacked":
            raise ValueError(
                "tables_for_model: kernel='fused' needs plan_exec='stacked' "
                "(the super-slab is layer-indexed)")
        if kernel == "fused" and mesh is not None:
            raise ValueError(
                "tables_for_model: kernel='fused' is the single-device "
                "fast path — build without a mesh")
        dev = resolve_device(device)
        form = self._FORMS[exec_]
        tables = {
            "backend": backend,
            "kernel": kernel,
            "sites": {k: sp.entry(form=form, packed=packed, device=dev)
                      for k, sp in self.sites.items()},
        }
        if kernel == "fused":
            from .stacked import MultiSiteSlabs

            grouped = {k: sp.stacked() for k, sp in self.sites.items()
                       if sp.per_layer}
            if grouped:
                tables["multi"] = MultiSiteSlabs.from_stacks(
                    grouped).entry(device=dev)
                for k in grouped:
                    tables["sites"][k] = {"multi": k}
        if mesh is not None:
            from .sharded import place_tables

            tables, _, _ = place_tables(tables, mesh, policy)
        return tables

    def table_bytes(self, plan_exec: str | None = None,
                    backend: str | None = None,
                    packed: bool | None = None) -> int:
        """Bytes of the serving tables in one execution form (the
        reference's ``ServingPlans.table_bytes``): prices the stacked
        padding against the unrolled layout and, on the ``"cuda"``
        backend, the bit-packed slabs against raw int32.  Counted on
        host tensors, so no card is needed."""
        from .stacked import tables_nbytes

        return tables_nbytes(self.tables_for_model(
            backend=backend, plan_exec=plan_exec, packed=packed,
            device="cpu"))

    def patched_config(self, cfg: ArchConfig) -> ArchConfig:
        return dataclasses.replace(cfg, lut_activation=True)

    def fused_available(self, plan_exec: str | None = None) -> bool:
        """True when these plans can serve the multi-site kernel K4
        (stacked execution and at least one per-layer site): the top rung
        of the serving degradation ladder (:mod:`.degrade`), on one
        device.  Under a mesh :func:`~repro_torch.serve.sharded.
        place_tables` refuses the super-slab, so every site goes through
        K1 / K2."""
        exec_ = plan_exec or self.plan_exec
        return exec_ == "stacked" and self.per_layer

    @property
    def per_layer(self) -> bool:
        return any(sp.per_layer for sp in self.sites.values())

    @property
    def total_cost(self) -> int:
        """Summed P-LUT cost of every table the runtime holds."""
        return sum(sp.cost for sp in self.sites.values())

    def summary(self) -> str:
        parts = []
        for sp in self.sites.values():
            n_tabs = len(sp.luts)
            tabs = f"{n_tabs} per-layer tables" if sp.per_layer else (
                f"shared by {sp.n_sites} sites")
            parts.append(
                f"{sp.site}({sp.act}): {sp.cost} P-LUTs, "
                f"{sp.dontcare_frac:.0%} don't-care, {tabs}")
        return (f"{self.arch} [{self.family}] serving plans "
                f"[calib={self.calib}] — " + "; ".join(parts)
                + f" | engine: {self.report.summary()}")


@dataclasses.dataclass(frozen=True)
class _SpecMeta:
    site: str
    act: str
    quant: dict
    per_layer: bool
    x_lo: float
    x_hi: float


def _shared_specs(cfg, site_specs, calibration, w_in, w_out, x_lo, x_hi):
    """Shared calibration: tabulate + calibrate once per distinct
    ``(function, domain)``; the per-layer specs are renamed views."""
    cache: dict[tuple, tuple[TableSpec, dict]] = {}

    def tabulate(sp):
        act = sp.fn_name(cfg)
        lo, hi = sp.domain() or (x_lo, x_hi)
        key = (act, lo, hi)
        if key not in cache:
            cache[key] = activation_table(
                act, calibration, w_in=w_in, w_out=w_out,
                x_lo=lo, x_hi=hi, name=f"act_{act}")
        spec, quant = cache[key]
        return spec, quant, act, lo, hi

    specs: list[TableSpec] = []
    metas: list[_SpecMeta] = []
    for sp in site_specs:
        if sp.per_layer:
            continue
        spec, quant, act, lo, hi = tabulate(sp)
        specs.append(dataclasses.replace(spec, name=sp.key))
        metas.append(_SpecMeta(sp.key, act, quant, False, lo, hi))
    for layer in range(cfg.n_layers):
        for sp in site_specs:
            if not sp.per_layer:
                continue
            spec, quant, act, lo, hi = tabulate(sp)
            specs.append(dataclasses.replace(spec,
                                             name=f"L{layer}/{sp.key}"))
            metas.append(_SpecMeta(sp.key, act, quant, True, lo, hi))
    return specs, metas


def _per_site_specs(cfg, site_specs, calib: CalibrationSet, w_in, w_out,
                    x_lo, x_hi):
    """Per-site calibration: one care mask (and output quantization) per
    ``(layer, site)``, falling back to the site-kind mask where no
    per-layer key exists.  ``w_out`` may be a per-site-kind dict (a
    site's layers share one width, so their plans stack)."""
    specs: list[TableSpec] = []
    metas: list[_SpecMeta] = []
    layered = cfg.family in PER_LAYER_FAMILIES

    def add(sp, layer):
        lyr = layer if (layered and sp.per_layer) else None
        care = calib.mask_for(sp.key, lyr)
        if care is None:
            raise ValueError(
                f"build_serving_plans: calibration has no mask for "
                f"site {sp.key!r} (layer {lyr}); captured sites: "
                f"{calib.sites()}")
        act = sp.fn_name(cfg)
        lo, hi = sp.domain() or (x_lo, x_hi)
        w_out_site = w_out[sp.key] if isinstance(w_out, dict) else w_out
        name = sp.key if layer is None else f"L{layer}/{sp.key}"
        spec, quant = activation_table(
            act, care=care, w_in=w_in, w_out=w_out_site, x_lo=lo, x_hi=hi,
            name=name)
        specs.append(spec)
        metas.append(_SpecMeta(sp.key, act, quant, sp.per_layer, lo, hi))

    for sp in site_specs:
        if not sp.per_layer:
            add(sp, None)
    for layer in range(cfg.n_layers):
        for sp in site_specs:
            if sp.per_layer:
                add(sp, layer)
    return specs, metas


def build_serving_plans(
    cfg: ArchConfig,
    calibration: np.ndarray | CalibrationSet,
    *,
    w_in: int | None = None,
    w_out: int | dict | None = None,
    x_lo: float = -8.0,
    x_hi: float = 8.0,
    compress_cfg: CompressConfig | None = None,
    workers: int | None = None,
    backend: str = "gather",
    plan_exec: str = "stacked",
    plan_cache: PlanCache | None = None,
    verbose: bool = False,
) -> ServingPlans:
    """Compress every activation site of ``cfg`` into serving tables (one
    :class:`TableSpec` per (layer, site kind)).  A shared calibration
    sample array gives identical per-layer tables that dedupe to one plan
    per site kind; a per-site :class:`~repro_torch.calib.CalibrationSet`
    gives every site its own care mask and the runtime one table per
    layer.  ``w_out`` may be a dict of per-site-kind output widths (the
    autotuner's width override, :mod:`repro_torch.tune.sweep`), on the
    per-site calibration path only; a key that is not a registered site
    kind raises.  Host-side only: the tables reach a device in
    :meth:`ServingPlans.tables_for_model`."""
    if backend not in BACKENDS:
        raise ValueError(f"build_serving_plans: unknown backend "
                         f"{backend!r} (expected one of {BACKENDS})")
    per_site = isinstance(calibration, CalibrationSet)
    if per_site:
        if calibration.w_in is None:
            raise ValueError(
                "build_serving_plans: CalibrationSet has no w_in — "
                "activation serving needs masks captured on the LUT input "
                "grid (repro_torch.calib.capture_model)")
        w_in = calibration.w_in
        x_lo, x_hi = calibration.x_lo, calibration.x_hi
    else:
        w_in = w_in or cfg.lut_act_bits_in
    site_specs = site_registry.active_sites(cfg)
    if isinstance(w_out, dict):
        if not per_site:
            raise ValueError(
                "build_serving_plans: per-site w_out overrides need a "
                "per-site CalibrationSet (shared calibration serves one "
                "table per activation kind)")
        missing = {sp.key for sp in site_specs} - set(w_out)
        if missing:
            raise ValueError(
                f"build_serving_plans: per-site w_out has no entry for "
                f"site kind(s) {sorted(missing)} (got {sorted(w_out)})")
        registered = {sp.key for sp in site_registry.all_sites()}
        unknown = set(w_out) - registered
        if unknown:
            raise ValueError(
                f"build_serving_plans: per-site w_out has unknown site "
                f"kind(s) {sorted(unknown)}; registered kinds: "
                f"{sorted(registered)}")
    else:
        w_out = w_out or cfg.lut_act_bits_out
    if per_site:
        specs, metas = _per_site_specs(cfg, site_specs, calibration, w_in,
                                       w_out, x_lo, x_hi)
    else:
        specs, metas = _shared_specs(cfg, site_specs, calibration, w_in,
                                     w_out, x_lo, x_hi)
    ccfg = compress_cfg or CompressConfig(**DEFAULT_COMPRESS)
    report = compress_network_report(specs, ccfg, workers=workers,
                                     verbose=verbose, cache=plan_cache)
    layered = per_site and cfg.family in PER_LAYER_FAMILIES
    site_plans: dict[str, SitePlan] = {}
    for meta, spec, plan in zip(metas, specs, report.plans):
        site = meta.site
        site_layered = layered and meta.per_layer
        lut = None
        if site_layered or site not in site_plans:
            lut = lut_activation_from_plan(
                plan, spec, meta.quant, x_lo=meta.x_lo, x_hi=meta.x_hi,
                exiguity=ccfg.exiguity)
        if site in site_plans:
            site_plans[site].n_sites += 1
            if lut is not None:
                site_plans[site].luts.append(lut)
            continue
        site_plans[site] = SitePlan(site=site, act=meta.act, luts=[lut],
                                    n_sites=1, per_layer=site_layered)
    return ServingPlans(arch=cfg.name, family=cfg.family, report=report,
                        sites=site_plans, backend=backend,
                        plan_exec=plan_exec,
                        calib="per_site" if per_site else "shared")


def greedy_decode(cfg, params, prompt, n_new: int,
                  max_seq: int | None = None, lut_tables=None
                  ) -> list[list[int]]:
    """``n_new`` greedy tokens per request, ``(B, n_new)`` as lists, after
    ``prompt``: (B, T) tokens, or a batch dict (a vlm's ``"patches"``
    with its ``"tokens"``, decoding then from ``n_patches + T``; an
    encdec model's ``"frames"``).
    The tokens stay on the device until the end (one host sync)."""
    return _greedy(cfg, params, prompt, n_new, max_seq, lut_tables)[0]


def _greedy(cfg, params, prompt, n_new: int, max_seq: int | None = None,
            lut_tables=None, serve=None):
    """``(tokens (B, n_new) as lists, last-position logits of the prefill
    and of every step)``; with ``serve`` (a
    :class:`~repro_torch.serve.sharded.ShardedServe`) through its sharded
    steps on this rank's rows."""
    from .decode import decode_start, decode_step, prefill

    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    t = decode_start(cfg, batch)
    max_seq = max_seq or (t + n_new)
    if serve is not None:
        logits, cache = serve.prefill(params, batch, max_seq)
        step = lambda c, tk, pos: serve.decode(params, c, tk, pos)
    else:
        logits, cache = prefill(params, cfg, batch, max_seq, lut_tables)
        step = lambda c, tk, pos: decode_step(params, cfg, c, tk, pos,
                                              lut_tables)
    tok = logits[:, -1].argmax(-1)[:, None]
    toks, seen = [], [logits[:, -1]]
    for i in range(n_new):
        toks.append(tok)
        logits, cache = step(cache, tok, t + i)
        seen.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
    return torch.cat(toks, dim=1).tolist(), seen


def verify_backend_equivalence(
    cfg: ArchConfig,
    params,
    plans: ServingPlans,
    prompt,                      # (B, T) int tokens, or a batch dict
    n_new: int,
    max_seq: int | None = None,
    plan_exec: str | None = None,
    mesh=None,
    table_overrides: dict | None = None,
    backends: tuple[str, ...] = BACKENDS,
) -> list[list[int]]:
    """Decode ``n_new`` greedy tokens with each of ``backends`` (the
    ``gather`` functions and the ``cuda`` kernels by default) on the
    parameters' device and assert they agree token for token.  Returns the
    first backend's ``(B, n_new)`` token lists.  The ``cuda`` backend
    needs the card (it raises on a CPU tensor), so a CPU caller names
    ``backends=("gather",)``: one backend is then held against no other,
    only, under a ``mesh``, its sharded run against its single-device one.
    ``prompt`` may be a batch dict of numpy arrays for a family whose
    prefill takes more than tokens (vlm patches, encdec frames), as in the
    reference.

    With ``mesh`` (every rank calls it, with the full ``params``), each
    backend also serves through :class:`~repro_torch.serve.sharded.
    ShardedServe` with policy-placed tables, and each rank asserts its
    rows' greedy tokens equal the single-device program's on the whole
    batch, and their per-step logits bit for bit wherever each data rank
    holds at least 2 rows (within ``atol=1e-4`` otherwise, where a one-row
    product may take another code path), as the reference does.  Holding
    the sharded run against the single-device one (not the two sharded
    backends against each other) is what catches a mis-replicated table:
    a failure on any rank raises on every rank.  ``table_overrides`` maps
    a backend to placed tables for its sharded run only.

    The matmul-epilogue form (``cfg.lut_fuse``) is not held to this: its
    GEMM sums in another order than ``torch.matmul``, so a GEMM output at a
    quantizer edge may land in the neighbouring bin."""
    cfg = plans.patched_config(cfg)
    dev = params.embed.device
    raw = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in raw.items()}
    batch["tokens"] = batch["tokens"].long()
    unknown = set(backends) - set(BACKENDS)
    if not backends or unknown:
        raise ValueError(f"verify_backend_equivalence: backends {backends} "
                         f"(expected a non-empty subset of {BACKENDS})")
    outs = {}
    for backend in backends:
        tables = plans.tables_for_model(backend=backend, plan_exec=plan_exec,
                                        device=dev)
        outs[backend], logits = _greedy(cfg, params, batch, n_new, max_seq,
                                        tables)
        if mesh is not None:
            _verify_sharded(cfg, params, plans, batch, n_new, max_seq,
                            plan_exec, mesh, backend, outs[backend], logits,
                            (table_overrides or {}).get(backend))
    first = backends[0]
    for other in backends[1:]:
        for r, (a, b) in enumerate(zip(outs[first], outs[other])):
            assert a == b, (f"backend divergence on request {r}: "
                            f"{first}={a} {other}={b}")
    return outs[first]


def _verify_sharded(cfg, params, plans, batch, n_new, max_seq, plan_exec,
                    mesh, backend, toks, logits, s_tables) -> None:
    """One backend's sharded run against its single-device ``toks`` /
    ``logits`` on this rank's rows (see :func:`verify_backend_equivalence`);
    raises on every rank if any rank diverges."""
    from repro_torch.nn.sharding import all_ranks_ok

    from .sharded import ShardedServe, batch_placement

    if s_tables is None:
        s_tables = plans.tables_for_model(backend=backend,
                                          plan_exec=plan_exec,
                                          device=params.embed.device,
                                          mesh=mesh)
    serve = ShardedServe(cfg, mesh, s_tables)
    s_toks, s_logits = _greedy(cfg, serve.place_params(params),
                               serve.place_batch(batch), n_new, max_seq,
                               serve=serve)
    b = batch["tokens"].shape[0]
    rows = batch_placement(mesh, {"i": torch.arange(b)})["i"].tolist()
    n_data = b // len(rows)
    bits = n_data == 1 or (b % n_data == 0 and b // n_data >= 2)
    err = None
    if s_toks != [toks[r] for r in rows]:
        err = (f"sharded {backend} decode diverges from the single-device "
               f"reference on rows {rows}: {s_toks} != "
               f"{[toks[r] for r in rows]}")
    for i, (ref, got) in enumerate(zip(logits, s_logits)):
        if err is not None:
            break
        ref = ref[rows]
        diff = float((ref.float() - got.float()).abs().max())
        if bits and not torch.equal(ref, got):
            err = (f"sharded {backend} logits not bit-identical to the "
                   f"single-device reference at step {i} on rows {rows} "
                   f"(max |diff| {diff})")
        elif not bits and not diff <= 1e-4:
            err = (f"sharded {backend} logits diverge from the "
                   f"single-device reference at step {i} on rows {rows} "
                   f"beyond ulp tolerance (max |diff| {diff})")
    if not all_ranks_ok(mesh, err is None):
        raise AssertionError(
            err or f"sharded {backend} decode diverges from the "
                   f"single-device reference on another rank")
