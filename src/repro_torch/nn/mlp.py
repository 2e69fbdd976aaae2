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

Layers run in an eager Python loop, so ``layer`` is always a Python int:
the stacked ``(L, …)`` tables are indexed with it directly and the
kernels read that layer's meta rows on the card (no host sync).
"""
from __future__ import annotations

import torch

from repro_torch import sites
from repro_torch.calib import capture as calib_capture
from repro_torch.kernels import ops
from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain
from repro_torch.kernels.lut_act import lut_act_plain, lut_act_stacked_plain

from .layers import activation_fn, is_gated, logits_projection

BACKENDS = ("gather", "cuda")


def _check_backend(backend: str, x: torch.Tensor) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown LUT backend {backend!r}; expected one "
                         f"of {BACKENDS}")
    if backend == "cuda" and x.device.type != "cuda":
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
    per-layer forms need ``layer``."""
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
        return {"multi_entry": lut_tables["multi"], "site": entry["multi"],
                "layer": layer}
    if "stacked" in entry:
        return {"stacked": entry["stacked"], "layer": layer}
    return entry["layers"][layer]


def apply_lut_act(x: torch.Tensor, tab: dict, backend: str = "gather"
                  ) -> torch.Tensor:
    """Evaluate one compressed-table activation entry on ``x``.

    ``"gather"`` runs the plain functions, ``"cuda"`` the kernels (K1 for
    stacked entries, K2 for per-plan ones); both compute the same bits.
    The backend is the one named at the top of ``lut_tables``."""
    _check_backend(backend, x)
    if "multi_entry" in tab:
        raise NotImplementedError(
            "apply_lut_act: a site served from the multi-site super-slab "
            "outside the fused matmul needs the multi-site kernel, which is "
            "not ported yet (ROADMAP queue B4); build tables with "
            "kernel='isolated'")
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
                           y_lo=meta["y_lo"], y_hi=meta["y_hi"])
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
                backend = lut_tables.get("backend", "gather")
                act = lambda x: apply_lut_act(x, tab, backend)
        cap = calib_capture.current()
    if act is None:
        act = activation_fn(fallback or cfg.activation)
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
            backend = lut_tables.get("backend", "gather")
            fn = lambda x: apply_lut_act(x, tab, backend)
    cap = calib_capture.current()
    if fn is None and cap is None:
        return None
    if fn is None:
        fn = sites.exact_fn(spec, cfg)
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
              layer: int | None = None) -> torch.Tensor:
    """(B, T, d) -> (B, T, d); swiglu uses the fused [gate|up] ``w_in``.

    Under ``cfg.lut_fuse`` the up-projection and the LUT activation run as
    one step: kernel K3 on the ``"cuda"`` backend, its plain version on
    ``"gather"``."""
    gated = is_gated(cfg.activation)
    ftab = fused_matmul_tab(cfg, lut_tables, sites.MLP, layer)
    if ftab is not None:
        backend = lut_tables.get("backend", "gather")
        _check_backend(backend, x)
        if backend == "cuda":
            h = ops.fused_matmul_lut(x, p["w_in"], ftab, gated=gated)
        else:
            k = x.shape[-1]
            h = fused_matmul_lut_plain(x.reshape(-1, k), p["w_in"], ftab,
                                       gated=gated)
            h = h.reshape(*x.shape[:-1], h.shape[-1])
        return torch.matmul(h, p["w_out"])
    act = make_activation(cfg, lut_tables, layer=layer)
    if gated:
        gate, up = torch.matmul(x, p["w_in"]).chunk(2, dim=-1)
        h = act(gate) * up
    else:
        h = act(torch.matmul(x, p["w_in"]))
    return torch.matmul(h, p["w_out"])
