"""Streaming per-site activation capture (PyTorch port of the reference's
``calib/capture.py``; paper SS4.1, serving side).

Every layer's nonlinearity sees a different input distribution, so every
(layer, site) pair earns its own observed-bin mask.  While an
:class:`ActivationCapture` context is active, each
:func:`repro_torch.nn.mlp.make_activation` call site streams its
pre-activation inputs into a per-site histogram (one ``2**w_in``-bin count
vector per ``L{layer}/{site}`` key) and its outputs into a ``[y_lo, y_hi]``
range.  The port runs its layer loop eagerly with Python layer ids, so the
tensors are concrete: binning happens on the tensor's device in float64
(the same operations as the reference's numpy binning) and only the
``2**w_in`` counts travel to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import sites

# Active captures, innermost last.  Capture is an eval-time tool run from
# one thread, so a plain module-level stack (as in the reference) keeps
# the check in make_activation cheap.
_STACK: list["ActivationCapture"] = []


def capture_active() -> bool:
    """True while any :class:`ActivationCapture` context is entered."""
    return bool(_STACK)


def current() -> "ActivationCapture | None":
    return _STACK[-1] if _STACK else None


def site_key(site: str, layer: int | None = None) -> str:
    """Canonical per-site key: ``"L{layer}/{site}"``, or the bare site kind
    when no layer identity is available.  Matches the ``TableSpec`` names
    :func:`repro_torch.serve.plans.build_serving_plans` assigns."""
    return site if layer is None else f"L{layer}/{site}"


class ActivationCapture:
    """Streaming observed-bin histogram accumulator.

    Bins follow the LUT activation's input quantizer exactly (uniform
    ``2**w_in`` grid over ``[x_lo, x_hi]``, round-to-nearest, clipped), so
    a bin with zero observations is precisely an input code the served
    table would never be asked for — a don't care.
    """

    def __init__(self, w_in: int = 10, x_lo: float = -8.0,
                 x_hi: float = 8.0):
        if x_hi <= x_lo:
            raise ValueError(
                f"ActivationCapture: empty input range "
                f"[x_lo={x_lo}, x_hi={x_hi}]")
        self.w_in = w_in
        self.x_lo = float(x_lo)
        self.x_hi = float(x_hi)
        # Per-key input-domain overrides (registry sites pin their own
        # quantizer range, e.g. the softmax exp over [-16, 0]); keys
        # without an entry histogram over the global [x_lo, x_hi].
        self.domains: dict[str, tuple[float, float]] = {}
        self.hists: dict[str, np.ndarray] = {}
        # Streaming per-site *output* range: key -> [y_lo, y_hi] float64.
        # The observed output span is what per-site w_out selection prices
        # (a site whose outputs occupy a fraction of the activation's full
        # range needs fewer output bits at the same resolution).
        self.ranges: dict[str, np.ndarray] = {}
        self.n_batches = 0
        self.n_samples = 0

    # -- context management ------------------------------------------------
    def __enter__(self) -> "ActivationCapture":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)

    # -- accumulation ------------------------------------------------------
    def _accum(self, key: str, x: torch.Tensor) -> None:
        flat = x.detach().reshape(-1).double()
        flat = flat[torch.isfinite(flat)]
        if flat.numel() == 0:
            return
        levels = (1 << self.w_in) - 1
        x_lo, x_hi = self.domains.get(key, (self.x_lo, self.x_hi))
        xn = torch.clamp((flat - x_lo) / (x_hi - x_lo), 0.0, 1.0)
        codes = torch.round(xn * levels).long()
        hist = self.hists.get(key)
        if hist is None:
            hist = self.hists.setdefault(
                key, np.zeros(1 << self.w_in, dtype=np.int64))
        hist += torch.bincount(codes, minlength=1 << self.w_in).cpu().numpy()
        self.n_samples += flat.numel()

    def _accum_out(self, key: str, y: torch.Tensor) -> None:
        flat = y.detach().reshape(-1).double()
        flat = flat[torch.isfinite(flat)]
        if flat.numel() == 0:
            return
        r = self.ranges.get(key)
        if r is None:
            r = self.ranges.setdefault(
                key, np.array([np.inf, -np.inf], dtype=np.float64))
        lo, hi = torch.aminmax(flat)
        r[0] = min(r[0], float(lo))
        r[1] = max(r[1], float(hi))

    def observe(self, site: str, layer: int | None, x,
                domain: tuple[float, float] | None = None) -> None:
        """Stream one site's pre-activation tensor into its histogram."""
        key = site_key(site, layer)
        # Register the key eagerly so the site inventory is complete even
        # before deferred callbacks flush.
        self.hists.setdefault(key, np.zeros(1 << self.w_in, dtype=np.int64))
        if domain is not None:
            self.domains[key] = (float(domain[0]), float(domain[1]))
        self._accum(key, torch.as_tensor(x))

    def observe_output(self, site: str, layer: int | None, y) -> None:
        """Stream one site's post-activation tensor into its range tracker."""
        key = site_key(site, layer)
        self.ranges.setdefault(
            key, np.array([np.inf, -np.inf], dtype=np.float64))
        self._accum_out(key, torch.as_tensor(y))

    def wrap(self, site: str, layer: int | None, act,
             domain: tuple[float, float] | None = None):
        """Wrap an activation callable so evaluating it records its input
        histogram and its output range.  ``domain`` pins this key's
        histogram quantizer range (registry sites with their own input
        domain); ``None`` keeps the capture-wide default."""
        def captured(x):
            self.observe(site, layer, x, domain=domain)
            y = act(x)
            self.observe_output(site, layer, y)
            return y
        return captured

    def observed_ranges(self) -> dict[str, np.ndarray]:
        """Finalized per-site output ranges (sites that saw data only)."""
        return {k: r.copy() for k, r in self.ranges.items()
                if np.isfinite(r).all() and r[1] >= r[0]}

    # -- inspection --------------------------------------------------------
    def sites(self) -> list[str]:
        return sorted(self.hists)

    def summary(self) -> str:
        per = ", ".join(
            f"{k}: {int((h > 0).sum())}/{h.size} bins"
            for k, h in sorted(self.hists.items()))
        return (f"capture[{self.n_batches} batches, "
                f"{self.n_samples} samples] {per}")


def model_batch(cfg, rng, batch_size: int, seq_len: int) -> dict:
    """One family-shaped random batch (tokens, and a vlm's patch
    embeddings or an encdec model's audio frames) — the single source of
    the batch-shaping convention shared by calibration capture and the
    serving launcher.  The draws are the reference's, in its order
    (tokens, then ``rng.normal`` patches or frames cast to float32), so
    both packages see the same numbers."""
    batch = {"tokens": np.asarray(
        rng.integers(1, cfg.vocab_size, (batch_size, seq_len)), np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = np.asarray(
            rng.normal(size=(batch_size, cfg.n_patches, cfg.d_model)),
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = np.asarray(
            rng.normal(size=(batch_size, cfg.n_frames, cfg.d_model)),
            np.float32)
    return batch


def synthetic_batches(cfg, steps: int, batch_size: int = 2,
                      seq_len: int = 16, seed: int = 0) -> list[dict]:
    """Random-token calibration batches (:func:`model_batch` per step)."""
    rng = np.random.default_rng(seed)
    return [model_batch(cfg, rng, batch_size, seq_len)
            for _ in range(steps)]


def capture_model(params, cfg, batches, *, w_in: int | None = None,
                  x_lo: float = -8.0, x_hi: float = 8.0,
                  capture: ActivationCapture | None = None,
                  ) -> ActivationCapture:
    """Stream calibration batches through the exact (non-LUT) forward of
    ``cfg``'s family (dense, moe, vlm with its batches' patches, ssm,
    hybrid, or encdec's encoder over the batches' frames and then its
    decoder), capturing every LUT site's observed input bins per layer
    (``L{i}/{site}`` keys, each binned over its site's domain; a moe
    layer's ``expert`` key sees every capacity slot, empty ones included,
    as in the reference).  The encdec encoder's sites stream into keys
    with no layer (``mlp``, and ``attn_exp`` in scope), which the
    per-layer keys shadow when masks are resolved, as in the reference.
    Batches go to the parameters' device."""
    from repro_torch.nn.mlp import project_logits
    from repro_torch.nn.transformer import (
        decoder_forward,
        encdec_forward,
        encoder_forward,
        hybrid_forward,
        rwkv_forward,
    )

    decoder = lambda toks, b: decoder_forward(params, cfg, toks,
                                              patches=b.get("patches"))[0]
    encdec = lambda toks, b: encdec_forward(
        params, cfg, toks, encoder_forward(params, cfg, b["frames"]))
    forwards = {"dense": decoder, "moe": decoder, "vlm": decoder,
                "ssm": lambda toks, _: rwkv_forward(params, cfg, toks)[0],
                "hybrid": lambda toks, _: hybrid_forward(params, cfg,
                                                         toks)[0],
                "encdec": encdec}
    dev = params.embed.device
    cap = capture or ActivationCapture(
        w_in=w_in or cfg.lut_act_bits_in, x_lo=x_lo, x_hi=x_hi)
    with cap, torch.no_grad():
        for batch in batches:
            if not isinstance(batch, dict):
                batch = {"tokens": batch}
            toks = torch.as_tensor(np.asarray(batch["tokens"], np.int32),
                                   device=dev).long()
            extra = {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                                        device=dev)
                     for k in ("patches", "frames") if k in batch}
            out = forwards[cfg.family](toks, extra)
            # the softcap site lives past the forward (hidden states, not
            # logits): project so the network-global histogram is observed
            if sites.site_spec(sites.LOGIT_SOFTCAP).active(cfg):
                project_logits(out, params.lm_head, cfg)
            cap.n_batches += 1
    return cap
