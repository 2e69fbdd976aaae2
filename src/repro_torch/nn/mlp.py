"""Feed-forward blocks with the LUT-approximated activation (PyTorch port
of the reference's ``nn/mlp.py``).

The LUT activation replaces the elementwise nonlinearity by quantize ->
compressed-table lookup -> dequantize over ReducedLUT plan arrays.  Two
backends evaluate it:

* ``"gather"`` — the plain PyTorch functions (indexing with the codes),
  on either device: the reference form, counterpart of the reference's
  ``jnp.take`` gather form;
* ``"cuda"`` — the hand-written kernels, always through the launch
  wrappers of :mod:`repro_torch.kernels.ops`; it needs tensors on the
  card and raises on a CPU tensor.

The backend is the one named at the top of ``lut_tables``, unless a site
entry carries its own ``"backend"`` key: the degradation ladder
(:mod:`repro_torch.serve.degrade`) serves a demoted site on a lower rung
that way while the others keep theirs.

Layers run in an eager Python loop, so ``layer`` is always a Python int:
the stacked ``(L, …)`` tables are indexed with it directly and the
kernels read that layer's meta rows on the card (no host sync).

While a don't-care monitor is active (:mod:`repro_torch.obs.drift`), the
served sites' activations are wrapped so the monitor counts their inputs
on the device.  The matmul-epilogue fusion (``--lut-fuse``) hides its
pre-activation inside kernel K3, and the reference falls back to its
unfused composition there, which is bit-identical to its fused kernel.
Here it is not (K3 sums in another order than cuBLAS), so a monitored
fused call computes the pre-activation with K3's own GEMM
(``epilogue=False``), lets the monitor see it, and applies K1 (times
``up``, rounded as K3 rounds): the composition K3 is held bit for bit
against, so monitored and plain steps serve the same tokens.
"""
from __future__ import annotations

import torch

from repro_torch import sites
from repro_torch.calib import capture as calib_capture
from repro_torch.kernels import ops
from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain
from repro_torch.obs import drift as obs_drift
from repro_torch.kernels.lut_act import (
    lut_act_multi_plain,
    lut_act_plain,
    lut_act_stacked_plain,
)

from .layers import activation_fn, is_gated, logits_projection
from .sharding import copy_to_tp, current_tp, reduce_from_tp

BACKENDS = ("gather", "cuda")


def _check_backend(backend: str, x: torch.Tensor) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown LUT backend {backend!r}; expected one "
                         f"of {BACKENDS}")
    if backend == "cuda" and not ops.on_card(x.device):
        raise ValueError(
            f"LUT backend 'cuda' runs the CUDA kernels and needs tensors on "
            f"the card, got one on {x.device} (use backend 'gather' on the "
            f"CPU)")


def site_tables(lut_tables: dict | None, site: str | None = None,
                layer: int | None = None) -> dict | None:
    """Resolve one site's table entry (default: the MLP activation site).

    Entry forms: shared ``{"meta", "arrays"}``, unrolled per-layer
    ``{"layers": [...]}``, stacked per-layer ``{"stacked": {...}}`` and the
    multi-site marker ``{"multi": site}`` into the shared super-slab; the
    per-layer forms need ``layer``.  An entry's ``"backend"`` key (the
    ladder's per-site override) is carried into the resolved dict."""
    lut_tables = sites.coerce_site_tables(lut_tables)
    if lut_tables is None:
        return None
    site = sites.MLP if site is None else site
    entry = lut_tables["sites"].get(site)
    if entry is None or not any(
            k in entry for k in ("layers", "stacked", "multi")):
        return entry
    if layer is None:
        raise ValueError(
            f"per-layer LUT tables for site {site!r} need a layer index")
    if "multi" in entry:
        out = {"multi_entry": lut_tables["multi"], "site": entry["multi"],
               "layer": layer}
    elif "stacked" in entry:
        out = {"stacked": entry["stacked"], "layer": layer}
    else:
        out = entry["layers"][layer]
    if "backend" in entry:
        out = dict(out, backend=entry["backend"])
    return out


def tab_backend(tab: dict, lut_tables: dict) -> str:
    """The backend one resolved entry runs on: its own ``"backend"`` key,
    else the one at the top of ``lut_tables``."""
    return tab.get("backend", lut_tables.get("backend", "gather"))


def apply_lut_act(x: torch.Tensor, tab: dict, backend: str = "gather"
                  ) -> torch.Tensor:
    """Evaluate one compressed-table activation entry on ``x``.

    ``"gather"`` runs the plain functions, ``"cuda"`` the kernels (K1 for
    stacked entries, K2 for per-plan ones, K4 for a site served out of the
    multi-site super-slab); both compute the same bits.  The entry's own
    ``"backend"`` key, where it has one, wins over ``backend``.  The
    gather form is the ``gather:lut_act`` fault point of
    :mod:`repro_torch.serve.faults` (the kernels' are in their wrappers)."""
    backend = tab.get("backend", backend)
    _check_backend(backend, x)
    if backend == "gather":
        ops.fault_hook("gather:lut_act")
        # the kernels count in their wrappers; the gather form here
        ops.note_launch("gather:lut_act_multi" if "multi_entry" in tab
                        else "gather:lut_act_stacked" if "stacked" in tab
                        else "gather:lut_act")
    if "multi_entry" in tab:
        site = tab["site"]
        multi = ops.lut_act_multi if backend == "cuda" else \
            lut_act_multi_plain
        return multi({site: x}, tab["multi_entry"], tab["layer"])[site]
    if "stacked" in tab:
        if backend == "cuda":
            return ops.lut_act_stacked(x, tab["stacked"], tab["layer"])
        return lut_act_stacked_plain(x, tab["stacked"], tab["layer"])
    meta, arrays = tab["meta"], tab["arrays"]
    if backend == "cuda":
        pa = ops.PlanArrays(
            kind="decomposed", w_in=meta["w_in"], w_out=meta["w_out"],
            l=meta["l"], w_lb=meta["w_lb"], w_hb=meta["w_hb"],
            arrays=arrays, pack=meta.get("pack"))
        return ops.lut_act(x, pa, x_lo=meta["x_lo"], x_hi=meta["x_hi"],
                           y_lo=meta["y_lo"], y_hi=meta["y_hi"],
                           record=tab.get("k1_record"))
    return lut_act_plain(x, arrays, **meta)


def fused_matmul_tab(cfg, lut_tables: dict | None, site: str,
                     layer: int | None = None) -> dict | None:
    """The site entry for the matmul-epilogue fused path, or ``None`` when
    the unfused composition must run: it needs ``cfg.lut_fuse``, served
    tables for an active site, and no activation capture (the capture must
    see the pre-activation tensor)."""
    if not (getattr(cfg, "lut_fuse", False) and cfg.lut_activation
            and lut_tables is not None):
        return None
    if calib_capture.capture_active():
        return None
    spec = sites.site_spec(site)
    if not spec.active(cfg):
        return None
    return site_tables(lut_tables, site, layer if spec.per_layer else None)


def fused_act_matmul(x: torch.Tensor, w: torch.Tensor, ftab: dict,
                     lut_tables: dict, *, gated: bool, site: str = sites.MLP,
                     layer: int | None = None) -> torch.Tensor:
    """``act(x @ w)`` (or the gated form) through the matmul-epilogue
    fusion: kernel K3 on the ``"cuda"`` backend, its plain version on
    ``"gather"``.  Under a drift monitor that wants ``site``, K3's GEMM
    alone, the monitor, then the LUT (module docstring)."""
    backend = tab_backend(ftab, lut_tables)
    _check_backend(backend, x)
    mon = obs_drift.current()
    if mon is not None and mon.wants(site):
        return _monitored_fused(x, w, ftab, backend, gated=gated,
                                mon=mon, site=site, layer=layer)
    if backend == "cuda":
        return ops.fused_matmul_lut(x, w, ftab, gated=gated)
    k = x.shape[-1]
    h = fused_matmul_lut_plain(x.reshape(-1, k), w, ftab, gated=gated)
    return h.reshape(*x.shape[:-1], h.shape[-1])


def _monitored_fused(x, w, ftab, backend, *, gated, mon, site, layer):
    """K3's own GEMM (``epilogue=False``; ``torch.matmul``, the plain
    version's product, on ``"gather"``), the monitor on the pre-activation,
    then the LUT as K3's epilogue applies it: K1 (or K2 for a per-plan
    entry) on the activation half, times ``up`` in the model dtype."""
    if backend == "cuda":
        h = ops.fused_matmul_lut(x, w, ftab, gated=gated, epilogue=False)
    else:
        h = torch.matmul(x, w)
    pre, up = h.chunk(2, dim=-1) if gated else (h, None)
    spec = sites.site_spec(site)
    mon.observe(site, layer if spec.per_layer else None, pre)
    if "multi_entry" in ftab:
        # K3's epilogue reads the site's K1 record in the super-slab
        from repro_torch.serve.stacked import multi_site_stacked_entry

        ftab = {"stacked": multi_site_stacked_entry(ftab["multi_entry"],
                                                    ftab["site"]),
                "layer": ftab["layer"]}
    y = apply_lut_act(pre, ftab, backend)
    return y * up if gated else y


def make_activation(cfg, lut_tables: dict | None, site: str | None = None,
                    fallback: str | None = None, layer: int | None = None):
    """Returns act(x) for the configured nonlinearity: the site's
    compressed table when served, else the exact ``fallback`` (default
    ``cfg.activation``); under an active capture the callable also streams
    its input and output into the capture's ``(layer, site)`` statistics."""
    site = sites.MLP if site is None else site
    spec = sites.site_spec(site)
    act = None
    cap = None
    if spec.active(cfg):
        if cfg.lut_activation and lut_tables is not None:
            tab = site_tables(lut_tables, site, layer)
            if tab is not None:
                backend = tab_backend(tab, lut_tables)
                act = lambda x: apply_lut_act(x, tab, backend)
        cap = calib_capture.current()
    if act is None:
        act = activation_fn(fallback or cfg.activation)
    mon = obs_drift.current()
    if mon is not None and spec.active(cfg):
        # drift monitor: counts this site's don't-care lookups into its
        # device counters (no host sync, so the step stays capturable)
        act = mon.wrap(site, layer, act)
    if cap is not None:
        act = cap.wrap(site, layer, act, domain=spec.domain())
    return act


def site_act(cfg, lut_tables: dict | None, site: str, layer=None):
    """One non-default scalar site as a callable, or ``None`` when the site
    is inactive and no capture runs (callers keep their exact inline
    math on ``None``)."""
    spec = sites.site_spec(site)
    if not spec.active(cfg):
        return None
    lyr = layer if spec.per_layer else None
    fn = None
    if cfg.lut_activation and lut_tables is not None:
        tab = site_tables(lut_tables, site, lyr)
        if tab is not None:
            backend = tab_backend(tab, lut_tables)
            fn = lambda x: apply_lut_act(x, tab, backend)
    cap = calib_capture.current()
    # the drift monitor observes served LUT lookups: it wraps only sites
    # evaluating a compressed table, so the None path stays the exact
    # inline math of the unmonitored forward
    mon = obs_drift.current()
    if fn is None and cap is None:
        return None
    if fn is None:
        fn = sites.exact_fn(spec, cfg)
    elif mon is not None:
        fn = mon.wrap(site, lyr, fn)
    if cap is not None:
        fn = cap.wrap(site, lyr, fn, domain=spec.domain())
    return fn


def project_logits(x, lm_head, cfg, lut_tables: dict | None = None):
    """Final logits projection, with optional tanh soft-capping (the
    softcap tanh is itself a registered LUT site)."""
    logits = logits_projection(x, lm_head)
    cap_scale = getattr(cfg, "logit_softcap", None)
    if not cap_scale:
        return logits
    scaled = logits.float() / cap_scale
    tanh = site_act(cfg, lut_tables, sites.LOGIT_SOFTCAP)
    capped = tanh(scaled) if tanh is not None else torch.tanh(scaled)
    return (cap_scale * capped).to(logits.dtype)


def mlp_block(p: dict, x: torch.Tensor, cfg, lut_tables=None,
              layer: int | None = None, tp_leaf: str = "blocks.w_in"
              ) -> torch.Tensor:
    """(B, T, d) -> (B, T, d); swiglu uses the fused [gate|up] ``w_in``.

    Under ``cfg.lut_fuse`` the up-projection and the LUT activation run as
    one step: kernel K3 on the ``"cuda"`` backend, its plain version on
    ``"gather"``.  In a partitioned train step that splits the leaf
    ``p["w_in"]`` is (``tp_leaf``: a dense block's ``blocks.w_in``, the moe
    shared experts' ``blocks.sh_w_in``;
    :func:`~repro_torch.nn.sharding.use_tp`) the block runs on the rank's
    shares: ``w_in`` column-parallel (a gated one as ``[gate_i |
    up_i]``), ``w_out`` row-parallel, its partial sums reduced over the
    model axis."""
    tp = current_tp()
    if tp is not None and tp.splits(tp_leaf):
        return reduce_from_tp(_mlp_plain(p, copy_to_tp(x), cfg, None, layer))
    return _mlp_plain(p, x, cfg, lut_tables, layer)


def _mlp_plain(p: dict, x: torch.Tensor, cfg, lut_tables, layer):
    gated = is_gated(cfg.activation)
    ftab = fused_matmul_tab(cfg, lut_tables, sites.MLP, layer)
    if ftab is not None:
        h = fused_act_matmul(x, p["w_in"], ftab, lut_tables, gated=gated,
                             layer=layer)
        return torch.matmul(h, p["w_out"])
    act = make_activation(cfg, lut_tables, layer=layer)
    if gated:
        gate, up = torch.matmul(x, p["w_in"]).chunk(2, dim=-1)
        h = act(gate) * up
    else:
        h = act(torch.matmul(x, p["w_in"]))
    return torch.matmul(h, p["w_out"])
