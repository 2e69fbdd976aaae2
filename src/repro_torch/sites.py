"""Declarative registry of LUT-compressible scalar sites (own copy of the
reference package's ``repro.sites``; :func:`exact_fn` returns torch
functions).

Every place the network evaluates a precomputed scalar map — the gated-MLP
nonlinearity, the MoE per-expert activation, the RWKV channel-mix
squared-ReLU, the softmax exponential, the rmsnorm inverse square root,
the logit softcap tanh, the rotary-embedding sine — is described by one
:class:`SiteSpec` here, and every downstream layer (capture keys, table
specs, plan dedupe, stacked slab building, sharded placement, sweep knob
grids, CLI flags) resolves sites through this registry instead of
hardcoded string literals.

A site is *hosted* by an architecture when its family appears in the
spec's ``families`` tuple and the spec's ``enabled`` gate passes (e.g.
the shared-expert MLP site only exists on MoE configs with
``n_shared > 0``).  A hosted site is *in scope* when the config's
``lut_sites`` selector covers it — ``"act"`` (default: just the three
activation sites, the pre-registry behavior), ``"all"`` (every
registered site), or an explicit tuple of site keys.

To register a new site::

    from repro_torch import sites

    sites.register_site(sites.SiteSpec(
        key="my_site", kind="act", fn="sigmoid",
        x_lo=-6.0, x_hi=6.0, families=("dense",),
        doc="where this scalar map lives"))

The registry is ordered: enumeration order is registration order, which
fixes capture-key order, table-spec order and stacked-slab layout.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

TWO_PI = 2.0 * math.pi

# Built-in site keys (the only place these strings are spelled).
MLP = "mlp"
EXPERT = "expert"
FFN = "ffn"
ATTN_EXP = "attn_exp"
NORM_RSQRT = "norm_rsqrt"
LOGIT_SOFTCAP = "logit_softcap"
ROPE = "rope_table"


def base_activation(name: str) -> str:
    """The elementwise nonlinearity inside a (possibly gated) MLP."""
    if name in ("swiglu", "silu"):
        return "silu"
    if name in ("geglu", "gelu"):
        return "gelu"
    return name


def _has_moe(cfg) -> bool:
    return cfg.family == "moe" or getattr(cfg, "moe", None) is not None


def _has_shared_mlp(cfg) -> bool:
    """Dense-style MLP block: every non-moe host, plus MoE shared experts."""
    if _has_moe(cfg):
        return cfg.moe is not None and bool(cfg.moe.n_shared)
    return True


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One LUT-compressible scalar site.

    ``fn`` names the scalar function tabulated at this site
    (an :data:`repro_torch.nn.lut_act.ACT_FNS` key); ``None`` means "the
    config's base activation" (the MLP-family sites).  ``x_lo``/``x_hi``
    are the input-domain hint for capture histograms and table
    quantization; ``None`` falls back to the global activation default.
    ``per_layer=False`` marks a network-global site (one table total,
    e.g. the logit softcap).  ``enabled`` is an extra per-config gate on
    top of the ``families`` membership test.
    """

    key: str
    kind: str                       # act | attn | norm | logits | pos
    fn: str | None = None           # None -> base_activation(cfg.activation)
    x_lo: float | None = None
    x_hi: float | None = None
    per_layer: bool = True
    families: tuple[str, ...] = ()
    enabled: Callable | None = None
    doc: str = ""

    def fn_name(self, cfg) -> str:
        return self.fn if self.fn is not None else base_activation(
            cfg.activation)

    def domain(self) -> tuple[float, float] | None:
        """(x_lo, x_hi) when the spec pins one, else None (caller default)."""
        if self.x_lo is None or self.x_hi is None:
            return None
        return (self.x_lo, self.x_hi)

    def hosts(self, cfg) -> bool:
        """Does this architecture contain this site at all?"""
        if cfg.family not in self.families:
            return False
        return self.enabled is None or bool(self.enabled(cfg))

    def in_scope(self, cfg) -> bool:
        """Does the config's ``lut_sites`` selector cover this site?"""
        scope = getattr(cfg, "lut_sites", "act")
        if scope == "act":
            return self.kind == "act"
        if scope == "all":
            return True
        return self.key in tuple(scope)

    def active(self, cfg) -> bool:
        return self.hosts(cfg) and self.in_scope(cfg)


_REGISTRY: dict[str, SiteSpec] = {}


def register_site(spec: SiteSpec) -> SiteSpec:
    """Add a site to the registry (idempotent only for identical specs)."""
    prev = _REGISTRY.get(spec.key)
    if prev is not None and prev != spec:
        raise ValueError(
            f"register_site: key {spec.key!r} already registered with a "
            f"different spec")
    _REGISTRY[spec.key] = spec
    return spec


def site_spec(key: str) -> SiteSpec:
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown site {key!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def all_sites() -> tuple[SiteSpec, ...]:
    """Every registered spec, in registration order."""
    return tuple(_REGISTRY.values())


def active_sites(cfg) -> tuple[SiteSpec, ...]:
    """The specs this config hosts *and* has in scope, in registry order."""
    return tuple(s for s in _REGISTRY.values() if s.active(cfg))


def hosted_sites(cfg) -> tuple[SiteSpec, ...]:
    """The specs this config hosts, ignoring the ``lut_sites`` scope."""
    return tuple(s for s in _REGISTRY.values() if s.hosts(cfg))


def exact_fn(spec: SiteSpec, cfg):
    """The exact torch scalar function a LUT at this site approximates."""
    import torch

    if spec.kind == "act":
        from repro_torch.nn.layers import activation_fn

        return activation_fn(spec.fn_name(cfg))
    return {
        "exp": torch.exp,
        "rsqrt": torch.rsqrt,
        "tanh": torch.tanh,
        "sin": torch.sin,
    }[spec.fn_name(cfg)]


def coerce_site_tables(lut_tables):
    """Deprecation shim: a bare single-table dict (the pre-sites format,
    ``{"meta": ..., "arrays": ...}`` with no ``"sites"`` key) is accepted
    as the MLP activation site's shared table.  New callers should pass
    ``{"sites": {<site key>: entry, ...}, "backend": ...}``.
    """
    if lut_tables is None or "sites" in lut_tables:
        return lut_tables
    warnings.warn(
        "passing a bare single-table dict as lut_tables is deprecated; "
        "wrap it as {'sites': {sites.MLP: entry}}",
        DeprecationWarning, stacklevel=3)
    return {"sites": {MLP: lut_tables}}


# --- built-in sites -------------------------------------------------------
# The three activation sites (kind="act") reproduce the pre-registry
# behavior exactly under the default lut_sites="act" scope; the four
# extra-kind sites below only activate under lut_sites="all" (or an
# explicit tuple).

register_site(SiteSpec(
    key=MLP, kind="act",
    families=("dense", "moe", "vlm", "hybrid", "encdec"),
    enabled=_has_shared_mlp,
    doc="dense FFN block nonlinearity (MoE: the shared-expert MLP)"))

register_site(SiteSpec(
    key=EXPERT, kind="act", fn="silu",
    families=("dense", "moe", "vlm"),
    enabled=_has_moe,
    doc="MoE per-expert gated activation"))

register_site(SiteSpec(
    key=FFN, kind="act", fn="relu2",
    families=("ssm",),
    doc="RWKV channel-mix squared-ReLU"))

register_site(SiteSpec(
    key=ATTN_EXP, kind="attn", fn="exp", x_lo=-16.0, x_hi=0.0,
    families=("dense", "moe", "vlm", "encdec"),
    doc="softmax exponential on max-shifted attention scores "
        "(hybrid/ssm excluded: recurrent layers host no attention, so "
        "their layer stacks would carry empty or misindexed slabs)"))

register_site(SiteSpec(
    key=NORM_RSQRT, kind="norm", fn="rsqrt", x_lo=1e-3, x_hi=64.0,
    families=("dense", "moe", "vlm", "ssm", "hybrid", "encdec"),
    doc="rmsnorm inverse square root of the mean square"))

register_site(SiteSpec(
    key=LOGIT_SOFTCAP, kind="logits", fn="tanh", x_lo=-4.0, x_hi=4.0,
    per_layer=False,
    families=("dense", "moe", "vlm", "ssm", "hybrid", "encdec"),
    enabled=lambda cfg: bool(getattr(cfg, "logit_softcap", None)),
    doc="tanh soft-capping of the final logits (network-global table)"))

register_site(SiteSpec(
    key=ROPE, kind="pos", fn="sin", x_lo=0.0, x_hi=TWO_PI,
    families=("dense", "moe", "vlm", "encdec"),
    doc="rotary-embedding sine over wrapped phase; cosine reuses the "
        "same table at phase + pi/2"))
