"""Don't-care hit-rate monitor, counted on the device (the live half of
paper SS4.1; counterpart of the reference's ``obs/drift.py``).

ReducedLUT injects don't cares where calibration traffic showed no
observations; the compressor is then free to rewrite those table entries.
The one thing a production deployment must therefore watch is the rate at
which *served* lookups land in don't-care bins — every such lookup reads
a rewritten entry, so the rate is the cheap online proxy for calibration
drift (and the trigger signal for a background retune).

:class:`DontCareMonitor` counts exactly that, per ``(layer, site)``:

* masks come from the :class:`~repro_torch.calib.masks.CalibrationSet`
  the active plan was compressed from, stacked into per-site-kind
  ``(L, 2**w_in)`` don't-care indicator slabs on the monitor's device
  (missing layers all-care), plus the any-layer union row for
  layer-agnostic call sites;
* the served pre-activation tensor is quantized with the reference's
  *jitted* code math over the site's quantizer domain —
  ``clamp((where(finite, x, x_lo) - f32(x_lo)) * f32(1/f32(x_hi - x_lo)),
  0, 1)``, then ``round(xn * levels)`` half to even: XLA rewrites the
  division by the constant span into a multiply by its float32
  reciprocal, so the reference run op by op can differ from its own
  jitted step on a bin edge, and the port follows the jitted step;
* the layer's indicator row (a Python int here: the port's layer loop is
  eager, so a layer past the stack takes the last row, the reference's
  ``mode="clip"``) is indexed with the codes and the masked sums are
  added **in place** into int64 counters on the same device: ``hits``,
  ``lookups`` and ``calls`` per key (``calls`` lets a key observed with
  no finite element still report 0 lookups, as the reference's does).

Nothing crosses to the host inside a step — no ``.item()``, no sync — so
a monitored decode step is captured in a CUDA graph like a plain one
(:class:`repro_torch.serve.graphs.CapturedStep`, which snapshots the
counters around its warm-up so that only served steps count).  A key's
counter is allocated the first time it is observed, which the capture's
warm-up always is; a new key while a graph is being captured raises.
:meth:`flush`, :meth:`drift` and the ``hits`` / ``lookups`` dicts read the
counters back, one transfer each.

The monitor observes; it never transforms — the wrapped activation's
output is returned untouched, so serving with the monitor on is
token-for-token identical to serving with it off.  When no monitor is
active the hook in ``make_activation`` is one ``None`` check: no kernel.
A monitor counts on one device: a tensor on another raises.

Activation follows the capture idiom: a module-level stack entered by
the context manager (or by :class:`repro_torch.obs.telemetry.Telemetry`).

Counting costs some fifteen small kernels per observed call, so counting
*every* decode step costs throughput.  ``sample_every=N`` is the
production knob: callers that own a step loop (the continuous batcher)
keep two token-identical steps — one under the ambient monitor, one under
:func:`suppressed` — and run the monitored one on every Nth step only.
The drift fraction is a ratio, so sampling leaves it unbiased;
``lookups`` / ``hits`` then count sampled traffic, not total.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch import sites
from repro_torch.calib.capture import site_key
from repro_torch.calib.masks import CalibrationSet
from repro_torch.device import resolve_device

_STACK: list["DontCareMonitor"] = []
_SUPPRESS = 0


def monitor_active() -> bool:
    """True while any :class:`DontCareMonitor` context is entered (and
    not locally suppressed)."""
    return bool(_STACK) and not _SUPPRESS


def current() -> "DontCareMonitor | None":
    return _STACK[-1] if _STACK and not _SUPPRESS else None


@contextlib.contextmanager
def suppressed():
    """Escape hatch: inside this context the active monitor is invisible
    (``monitor_active()`` is False), so a step run or captured here is
    the plain, count-free step even while a monitor context is entered.
    This is how a step loop gets both the monitored and the unmonitored
    step for ``sample_every`` scheduling."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def _split_key(key: str) -> tuple[str, int | None]:
    """``"L{i}/{site}"`` -> (site, i); bare keys -> (key, None)."""
    if "/" in key:
        lpart, site = key.split("/", 1)
        if lpart.startswith("L") and lpart[1:].isdigit():
            return site, int(lpart[1:])
    return key, None


def _device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DontCareMonitor:
    """Per-(layer, site) served don't-care lookup counters on ``device``
    (the card unless named).

    ``sample_every=N`` asks monitoring step loops to run the monitored
    step on every Nth step only (the monitor itself still counts
    everything it observes — the knob is honoured by the loop that picks
    which step to call, see
    :meth:`ContinuousBatcher._pick_step <repro_torch.serve.batching.ContinuousBatcher>`).
    """

    def __init__(self, calib: CalibrationSet, *, sample_every: int = 1,
                 device=None):
        self.sample_every = max(1, int(sample_every))
        if calib.w_in is None:
            raise ValueError(
                "DontCareMonitor needs a calibration with a fixed input "
                "quantizer width (w_in=None is the LUT-NN mask form)")
        self.calib = calib
        self.w_in = int(calib.w_in)
        self.device = _device(device)
        n_bins = 1 << self.w_in
        # site kind -> {layer or None: don't-care indicator vector}
        by_kind: dict[str, dict[int | None, np.ndarray]] = {}
        for key, mask in calib.masks.items():
            kind, layer = _split_key(key)
            if mask.size != n_bins:
                continue        # heterogeneous-width (LUT-NN) masks
            by_kind.setdefault(kind, {})[layer] = ~np.asarray(mask, bool)
        # Device slabs: per-layer kinds get an (L, n_bins) int32 stack
        # (missing layers all-care, i.e. count nothing) plus the
        # any-layer-cares union row for layer-agnostic call sites;
        # layer-agnostic kinds a single (n_bins,) row.
        self._dc: dict[str, torch.Tensor] = {}
        self._dc_union: dict[str, torch.Tensor] = {}
        self._quant: dict[str, tuple[float, float]] = {}
        on_dev = lambda a: torch.as_tensor(a, device=self.device)
        for kind, rows in by_kind.items():
            layered = [l for l in rows if l is not None]
            if layered:
                stack = np.zeros((max(layered) + 1, n_bins), np.int32)
                for l in layered:
                    stack[l] = rows[l]
                self._dc[kind] = on_dev(stack)
                union = stack.max(axis=0)
                if None in rows:
                    union = np.maximum(union, rows[None].astype(np.int32))
                self._dc_union[kind] = on_dev(union.astype(np.int32))
            else:
                self._dc_union[kind] = on_dev(rows[None].astype(np.int32))
            try:
                domain = sites.site_spec(kind).domain()
            except KeyError:
                domain = None
            x_lo, x_hi = domain or (calib.x_lo, calib.x_hi)
            # the jitted reference's float32 constants: f32(x_lo) and the
            # reciprocal of the span rounded to float32 first
            self._quant[kind] = (
                float(np.float32(x_lo)),
                float(np.float32(1.0) / np.float32(x_hi - x_lo)))
        self._levels = float((1 << self.w_in) - 1)
        # key -> int64 [hits, lookups, calls] on the device
        self._counts: dict[str, torch.Tensor] = {}
        self._mesh = None
        self._split_kinds: tuple = ()

    def bind_mesh(self, mesh, split_kinds: tuple = ()) -> None:
        """Count under a mesh: each data rank counts its own rows, and
        :meth:`counts` sums the ranks' hits and lookups over the data axes
        (over the model axis too for ``split_kinds``, the sites whose
        inputs split over it: the experts of an expert-parallel moe), so
        the sums equal a single-device run's on the same batches.  Every
        rank then reads the counters at the same points (a collective)."""
        self._mesh = mesh
        self._split_kinds = tuple(split_kinds)

    def _sum_ranks(self, keys: list, stacked: torch.Tensor) -> torch.Tensor:
        from repro_torch.nn.sharding import DP_AXES, TP_AXIS, all_reduce

        hl = stacked[:, :2].contiguous()
        for a in DP_AXES:
            all_reduce(hl, self._mesh, a)
        split = [i for i, k in enumerate(keys)
                 if _split_key(k)[0] in self._split_kinds]
        if split:
            rows = hl[split].contiguous()
            hl[split] = all_reduce(rows, self._mesh, TP_AXIS)
        return torch.cat([hl, stacked[:, 2:]], dim=1)

    # -- context management --------------------------------------------------
    def __enter__(self) -> "DontCareMonitor":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)

    # -- accumulation --------------------------------------------------------
    def wants(self, site: str) -> bool:
        return site in self._dc or site in self._dc_union

    def _counter(self, key: str) -> torch.Tensor:
        cnt = self._counts.get(key)
        if cnt is None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"DontCareMonitor: key {key!r} first observed while a "
                    f"CUDA graph is captured; its counter must exist "
                    f"before the capture (run the step once first)")
            cnt = self._counts[key] = torch.zeros(
                3, dtype=torch.int64, device=self.device)
        return cnt

    def observe(self, site: str, layer, x: torch.Tensor) -> None:
        """Count ``x``'s don't-care lookups for ``site`` at ``layer`` (a
        Python int, or ``None`` for layer-agnostic sites) into the device
        counters, with no host sync."""
        if not self.wants(site):
            return
        if x.device != self.device:
            raise ValueError(
                f"DontCareMonitor: a tensor on {x.device}, the monitor "
                f"counts on {self.device}")
        x_lo, inv_span = self._quant[site]
        xf = x.float()
        finite = torch.isfinite(xf)
        xn = torch.clamp((torch.where(finite, xf, x_lo) - x_lo) * inv_span,
                         0.0, 1.0)
        code = torch.round(xn * self._levels).long()
        dc = self._dc.get(site)
        if dc is not None and layer is not None:
            row = dc[min(max(int(layer), 0), dc.shape[0] - 1)]
            key = site_key(site, int(layer))
        else:
            row = self._dc_union[site]
            key = site
        cnt = self._counter(key)
        cnt[0].add_(torch.where(finite, row[code], 0).sum())
        cnt[1].add_(finite.sum())
        cnt[2].add_(1)

    def wrap(self, site: str, layer, act):
        """Wrap an activation callable so evaluating it counts its input's
        don't-care lookups; the output passes through untouched."""
        if not self.wants(site):
            return act

        def monitored(x):
            self.observe(site, layer, x)
            return act(x)

        return monitored

    # -- counters ------------------------------------------------------------
    def snapshot_counts(self) -> dict[str, torch.Tensor]:
        """A copy of every counter (on the device, no sync)."""
        return {k: c.clone() for k, c in self._counts.items()}

    def restore_counts(self, snap: dict[str, torch.Tensor]) -> None:
        """Put the counters back to ``snap``; keys allocated since count
        nothing (their ``calls`` are 0, so they stay unreported)."""
        for k, c in self._counts.items():
            if k in snap:
                c.copy_(snap[k])
            else:
                c.zero_()

    def counts(self) -> dict[str, tuple[int, int, int]]:
        """``{key: (hits, lookups, calls)}`` of every observed key, read
        back from the device in one transfer."""
        keys = [k for k in self._counts]
        if not keys:
            return {}
        stacked = torch.stack([self._counts[k] for k in keys])
        if self._mesh is not None:
            stacked = self._sum_ranks(keys, stacked)
        host = stacked.cpu().tolist()
        return {k: tuple(v) for k, v in zip(keys, host) if v[2] > 0}

    @property
    def hits(self) -> dict[str, int]:
        return {k: v[0] for k, v in self.counts().items()}

    @property
    def lookups(self) -> dict[str, int]:
        return {k: v[1] for k, v in self.counts().items()}

    # -- reporting -----------------------------------------------------------
    def flush(self) -> None:
        """Wait for the counting work queued on the device (the
        reference's callback barrier); the readers below sync anyway."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calib_dontcare_traffic(self, key: str) -> float | None:
        """Fraction of *calibration-time* traffic that landed in this
        key's (now) don't-care bins — the baseline a served drift ratio
        is judged against (~0 by construction at min_count=1, nonzero
        when coverage/min_count trimmed observed tail bins)."""
        if self.calib.hists is None:
            return None
        mask = self.calib.masks.get(key)
        hist = self.calib.hists.get(key)
        if mask is None or hist is None or hist.sum() == 0:
            return None
        return float(hist[~mask].sum() / hist.sum())

    def drift(self) -> dict[str, dict]:
        """Per-key drift rows: served lookups, don't-care hits, the served
        don't-care fraction, the calibration-time baseline, and their
        difference (``excess`` — the actionable drift signal)."""
        counts = self.counts()
        out = {}
        for key in sorted(counts):
            h, n, _ = counts[key]
            served = h / n if n else 0.0
            base = self.calib_dontcare_traffic(key)
            out[key] = {
                "lookups": n,
                "dontcare_hits": h,
                "served_dontcare_frac": round(served, 6),
                "calib_dontcare_frac": (None if base is None
                                        else round(base, 6)),
                "excess": round(served - (base or 0.0), 6),
            }
        return out

    def summary(self) -> str:
        rows = self.drift()
        if not rows:
            return "dontcare-monitor[no lookups observed]"
        parts = [f"{k}: {r['dontcare_hits']}/{r['lookups']} "
                 f"({r['served_dontcare_frac']:.4f})"
                 for k, r in rows.items()]
        return "dontcare-monitor[" + ", ".join(parts) + "]"
