"""Stacked plan execution: per-layer compressed tables as one (L, …) family.

Host side of the reference's ``serve/stacked.py``.  Every ``(layer, site)``
carries its own ReducedLUT plan, and plans differ in shape, so each
component array (``t_ust``/``t_idx``/``t_rsh``/``t_bias``/``t_lb``) is
zero-padded to the per-site maximum across layers and stacked to one
``(L, n_max)`` int32 array; the per-layer scalars become ``(L, 3)`` int32
(``l``, ``w_lb``, ``w_hb``) and ``(L, 2)`` float32 (``y_lo``,
``y_hi - y_lo``) tables.  The span is computed in float64 on the host and
rounded once to float32 — the rounding the per-plan path's constant gets —
so stacked and per-plan evaluation give the same bits.

The host arrays are numpy and byte-identical to the reference's; the
plain-dict :meth:`StackedPlanArrays.entry` form holds torch tensors on the
serving device and is what :func:`repro_torch.nn.mlp.apply_lut_act` and
the K1/K3 kernels consume.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.packing import (
    COMPONENTS,
    MAX_PACK_WIDTH,
    pack_array,
)

# Meta keys that must be constant across a site's layers.
SHARED_META = ("w_in", "w_out", "x_lo", "x_hi")


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class StackedPlanArrays:
    """Padded ``(L, …)`` stacks of one site's per-layer plan arrays."""

    n_layers: int
    w_in: int
    w_out: int
    x_lo: float
    x_hi: float
    any_lb: bool
    arrays: dict                 # component -> (L, n_max) np.int32
    meta_i: np.ndarray           # (L, 3) int32   [l, w_lb, w_hb]
    meta_f: np.ndarray           # (L, 2) float32 [y_lo, y_hi - y_lo]
    lens: dict                   # component -> per-layer true lengths

    @staticmethod
    def from_entries(entries: list[dict]) -> "StackedPlanArrays":
        """Stack per-layer ``{"meta", "arrays"}`` entries (numpy arrays)."""
        if not entries:
            raise ValueError("StackedPlanArrays: no per-layer entries")
        metas = tuple(dict(e["meta"]) for e in entries)
        for key in SHARED_META:
            vals = {m[key] for m in metas}
            if len(vals) != 1:
                raise ValueError(
                    f"StackedPlanArrays: per-layer plans disagree on "
                    f"{key!r} ({sorted(vals)}) — a site's layers must share "
                    f"one input/output quantizer to stack")
        lens = {c: tuple(int(np.asarray(e["arrays"][c]).shape[0])
                         for e in entries) for c in COMPONENTS}
        arrays = {}
        for c in COMPONENTS:
            n_max = max(lens[c])
            rows = [np.pad(np.asarray(e["arrays"][c], dtype=np.int32),
                           (0, n_max - n))
                    for e, n in zip(entries, lens[c])]
            arrays[c] = np.stack(rows)
        meta_i = np.array([[m["l"], m["w_lb"], m["w_hb"]] for m in metas],
                          np.int32)
        # span rounded f64 -> f32 once, matching the per-plan path's
        # (y_hi - y_lo) constant bit for bit
        meta_f = np.array([[m["y_lo"], m["y_hi"] - m["y_lo"]]
                           for m in metas], np.float32)
        m0 = metas[0]
        return StackedPlanArrays(
            n_layers=len(entries), w_in=m0["w_in"], w_out=m0["w_out"],
            x_lo=m0["x_lo"], x_hi=m0["x_hi"],
            any_lb=any(m["w_lb"] > 0 for m in metas),
            arrays=arrays, meta_i=meta_i, meta_f=meta_f, lens=lens)

    def entry(self, packed: bool = False, device=None) -> dict:
        """The plain-dict form the runtime consumes, as tensors on
        ``device``.  ``packed=True`` bit-packs each ``(L, n)`` stack along
        its last axis at one width per component, with the unpack
        parameters in ``meta["pack"]`` (the kernel backend's form).
        Off the CPU (where the kernels run) ``"k1_record"`` is the LUT
        kernels' launch record of these tensors, built and validated here,
        once per entry."""
        from repro_torch.kernels.lut_act import stacked_record

        dev = resolve_device(device)
        meta = {"w_in": self.w_in, "w_out": self.w_out,
                "x_lo": self.x_lo, "x_hi": self.x_hi,
                "any_lb": self.any_lb, "n_layers": self.n_layers}
        arrays = self.arrays
        if packed:
            arrays, pack = self.packed_arrays()
            meta["pack"] = pack
        out = {
            "meta": meta,
            "arrays": {c: _to(a, dev) for c, a in arrays.items()},
            "meta_i": _to(self.meta_i, dev),
            "meta_f": _to(self.meta_f, dev),
        }
        if dev.type != "cpu":
            out["k1_record"] = stacked_record(out)
        return out

    def packed_arrays(self) -> tuple[dict, dict]:
        """Bit-packed ``(L, n_words)`` host stacks + unpack meta, memoized
        per instance."""
        cached = getattr(self, "_packed", None)
        if cached is None:
            arrays, pack = {}, {}
            for c in COMPONENTS:
                arrays[c], pack[c] = pack_array(self.arrays[c])
            cached = (arrays, pack)
            object.__setattr__(self, "_packed", cached)
        return cached


@dataclasses.dataclass
class MultiSiteSlabs:
    """Every per-layer site family as ONE ``(S, L, n)`` bit-packed
    super-slab (host side of the reference's ``MultiSiteSlabs``).

    * ``meta_i`` ``(S, L, 3)`` int32 — per-(site, layer) ``l``/``w_lb``/
      ``w_hb``;
    * ``meta_f`` ``(S, L, 4)`` float32 — ``y_lo``/``y_span`` per (site,
      layer) plus the per-site ``x_lo``/``1/x_span``, host-rounded;
    * ``meta_q`` ``(S, 2)`` float32 — ``2^w_in - 1`` and
      ``1 / (2^w_out - 1)``;
    * ``meta_p`` ``(S, C, 3)`` int32 — width/offset/per_word per (site,
      component).

    The port serves a site out of it through K4, which reads the whole
    super-slab, and through K1 and K3 on the site's static slice
    (:func:`multi_site_stacked_entry`).
    """

    sites: tuple
    n_layers: int
    any_lb: bool
    arrays: dict                 # component -> (S, L, n_words_max) int32
    meta_i: np.ndarray
    meta_f: np.ndarray
    meta_q: np.ndarray
    meta_p: np.ndarray
    site_meta: dict              # site -> python statics (static slicing)

    @staticmethod
    def from_stacks(stacks: dict) -> "MultiSiteSlabs":
        """Build from ``{site: StackedPlanArrays}`` (insertion order fixes
        the site ids)."""
        if not stacks:
            raise ValueError("MultiSiteSlabs: no site stacks")
        n_layers = {s.n_layers for s in stacks.values()}
        if len(n_layers) != 1:
            raise ValueError(
                f"MultiSiteSlabs: sites disagree on n_layers "
                f"({sorted(n_layers)}) — they cannot share one layer loop")
        order = tuple(stacks)
        packed = {site: st.packed_arrays() for site, st in stacks.items()}
        for site, (_, pack) in packed.items():
            for c, p in pack.items():
                if p["width"] > MAX_PACK_WIDTH:
                    raise ValueError(
                        f"MultiSiteSlabs: site {site!r} component {c} "
                        f"needs width {p['width']} > {MAX_PACK_WIDTH} — "
                        f"serve it isolated instead")
        arrays = {}
        for c in COMPONENTS:
            w_max = max(int(packed[s][0][c].shape[1]) for s in order)
            rows = [np.pad(packed[s][0][c],
                           ((0, 0), (0, w_max - packed[s][0][c].shape[1])))
                    for s in order]
            arrays[c] = np.stack(rows)
        meta_i = np.stack([stacks[s].meta_i for s in order])
        mf = []
        for s in order:
            st = stacks[s]
            inv_span = np.float32(1.0) / np.float32(st.x_hi - st.x_lo)
            dom = np.tile(np.array([[st.x_lo, inv_span]], np.float32),
                          (st.n_layers, 1))
            mf.append(np.concatenate([st.meta_f, dom], axis=1))
        meta_f = np.stack(mf)
        meta_q = np.array(
            [[np.float32((1 << stacks[s].w_in) - 1),
              np.float32(1.0) / np.float32((1 << stacks[s].w_out) - 1)]
             for s in order], np.float32)
        meta_p = np.array(
            [[[packed[s][1][c]["width"], packed[s][1][c]["offset"],
               packed[s][1][c]["per_word"]] for c in COMPONENTS]
             for s in order], np.int32)
        site_meta = {
            s: {"w_in": stacks[s].w_in, "w_out": stacks[s].w_out,
                "x_lo": stacks[s].x_lo, "x_hi": stacks[s].x_hi,
                "any_lb": stacks[s].any_lb, "n_layers": stacks[s].n_layers,
                "pack": packed[s][1]}
            for s in order}
        return MultiSiteSlabs(
            sites=order, n_layers=next(iter(n_layers)),
            any_lb=any(st.any_lb for st in stacks.values()),
            arrays=arrays, meta_i=meta_i, meta_f=meta_f, meta_q=meta_q,
            meta_p=meta_p, site_meta=site_meta)

    def entry(self, device=None) -> dict:
        """The plain-dict form the runtime consumes, tensors on ``device``;
        off the CPU with ``"site_records"``, each site's launch record of
        the LUT kernels over its slice (K1 and K3 serve a site through
        it), and ``"k4_record"``, the multi-site kernel's record over all
        of them, built here, once per entry."""
        from repro_torch.kernels.lut_act import MultiLaunch, stacked_record

        dev = resolve_device(device)
        out = {
            "meta": {"sites": self.sites, "n_layers": self.n_layers,
                     "any_lb": self.any_lb, "site_meta": self.site_meta},
            "arrays": {c: _to(a, dev) for c, a in self.arrays.items()},
            "meta_i": _to(self.meta_i, dev),
            "meta_f": _to(self.meta_f, dev),
            "meta_q": _to(self.meta_q, dev),
            "meta_p": _to(self.meta_p, dev),
        }
        if dev.type != "cpu":
            out["site_records"] = {
                s: stacked_record(multi_site_stacked_entry(out, s))
                for s in self.sites}
            out["k4_record"] = MultiLaunch(out["site_records"], self.sites)
        return out


def multi_site_stacked_entry(entry: dict, site: str) -> dict:
    """One site's slice of a multi-site ``entry()`` as a packed stacked
    entry — views into the shared super-slab, no copy.  Its ``meta_f`` is
    the ``(L, 2)`` column slice ``[y_lo, y_span]``, whose rows stay
    contiguous for the kernels.  Carries the site's launch record where
    the entry has one."""
    meta = entry["meta"]
    sid = meta["sites"].index(site)
    sm = meta["site_meta"][site]
    out = {
        "meta": {"w_in": sm["w_in"], "w_out": sm["w_out"],
                 "x_lo": sm["x_lo"], "x_hi": sm["x_hi"],
                 "any_lb": sm["any_lb"], "n_layers": sm["n_layers"],
                 "pack": sm["pack"]},
        "arrays": {c: entry["arrays"][c][sid] for c in COMPONENTS},
        "meta_i": entry["meta_i"][sid],
        "meta_f": entry["meta_f"][sid, :, :2],
    }
    if "site_records" in entry:
        out["k1_record"] = entry["site_records"][site]
    return out


def tables_nbytes(lut_tables) -> int:
    """Total bytes of every tensor in a ``lut_tables`` dict."""
    if isinstance(lut_tables, torch.Tensor):
        return lut_tables.numel() * lut_tables.element_size()
    if isinstance(lut_tables, dict):
        return sum(tables_nbytes(v) for v in lut_tables.values())
    if isinstance(lut_tables, (list, tuple)):
        return sum(tables_nbytes(v) for v in lut_tables)
    return 0
