"""Fault injection for the serving control plane (PyTorch port of the
reference's ``serve/faults.py``).

The control plane's whole job is surviving failures that never happen in
a clean run: corrupt plan artifacts, kernel build or launch faults, a
retune pipeline that hangs mid-upload.  This module makes those failures
*schedulable*: a :class:`FaultInjector` is a context manager that arms
named fault points, and instrumented call sites consult the active
injectors on every Python-level call.

    with FaultInjector() as inj:
        inj.inject("cuda:lut_act_multi", times=2)
        batcher.run()          # ladder demotes, re-probes, re-promotes

Instrumentation costs one dict lookup when nothing imported this module,
and the kernels package never imports it: its wrappers find it through
``sys.modules`` (:func:`repro_torch.kernels.ops.fault_hook`).

Fault points armed today:

* ``cuda:lut_act`` / ``cuda:lut_act_stacked`` / ``cuda:lut_act_multi`` /
  ``cuda:lut_reconstruct`` — the kernel wrappers' entry (K2, K1, K4, K5),
  standing in for kernel build and launch failures.  A wrapper's Python
  runs on an eager call and while a CUDA graph is captured, never at a
  replay, so the fault surfaces at an eager step or at (re)capture;
* ``gather:lut_act`` — the gather evaluator's entry
  (``nn/mlp.py::apply_lut_act``), so a drill runs on the CPU too (the
  reference has no such point: its gather form is never expected to
  fail);
* ``reload:load`` — the reloader's artifact read, for slow or stuck
  reload drills (``delay=...`` with ``exc=None`` models
  slow-but-successful).

The corruption helpers (:func:`corrupt_file`, :func:`corrupt_rung`)
stage the *data* faults: truncated or bit-flipped artifacts on disk and
corrupted served table slabs in memory.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

_ACTIVE: list["FaultInjector"] = []


@dataclasses.dataclass
class _Rule:
    point: str
    exc: type | None
    message: str | None
    times: int | None          # fire at most this many times (None = always)
    after: int                 # skip the first `after` hits
    delay: float               # sleep before raising (slow-path faults)
    hits: int = 0
    fired: int = 0


class FaultInjector:
    """Arms fault points while entered; rules fire on matching hits."""

    def __init__(self):
        self.rules: dict[str, _Rule] = {}
        self.log: list[tuple[str, int]] = []

    def inject(self, point: str, exc: type | None = RuntimeError,
               message: str | None = None, times: int | None = None,
               after: int = 0, delay: float = 0.0) -> "FaultInjector":
        """Arm ``point``: after skipping ``after`` hits, the next
        ``times`` hits sleep ``delay`` seconds and raise ``exc``
        (``exc=None`` = delay only, the slow-but-successful fault)."""
        self.rules[point] = _Rule(point, exc, message, times, after, delay)
        return self

    def clear(self, point: str | None = None) -> None:
        if point is None:
            self.rules.clear()
        else:
            self.rules.pop(point, None)

    def fire(self, point: str) -> None:
        rule = self.rules.get(point)
        if rule is None:
            return
        rule.hits += 1
        if rule.hits <= rule.after:
            return
        if rule.times is not None and rule.fired >= rule.times:
            return
        rule.fired += 1
        self.log.append((point, rule.hits))
        if rule.delay:
            time.sleep(rule.delay)
        if rule.exc is not None:
            raise rule.exc(
                rule.message or f"injected fault at {point}")

    def __enter__(self) -> "FaultInjector":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.remove(self)
        return False


def fault_point(point: str) -> None:
    """Instrumentation hook: fire every active injector's rule for
    ``point`` (no-op unless a :class:`FaultInjector` is entered)."""
    for inj in list(_ACTIVE):
        inj.fire(point)


def injection_active() -> bool:
    return bool(_ACTIVE)


# ---------------------------------------------------------------------------
# Data faults: corrupt artifacts on disk, corrupt table slabs in memory
# ---------------------------------------------------------------------------
def corrupt_file(src: str, dst: str, mode: str = "bitflip",
                 seed: int = 0, n_flips: int = 16) -> str:
    """Write a corrupted copy of ``src`` to ``dst``.

    ``mode="truncate"`` keeps the first 60% of the bytes (a torn write or
    an interrupted upload); ``mode="bitflip"`` flips ``n_flips`` random
    bits in the back three quarters (payload damage the zip directory
    may survive)."""
    with open(src, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[:max(1, int(len(data) * 0.6))]
    elif mode == "bitflip":
        rng = np.random.default_rng(seed)
        for _ in range(n_flips):
            i = int(rng.integers(len(data) // 4, len(data)))
            data[i] ^= 1 << int(rng.integers(8))
    else:
        raise ValueError(f"corrupt_file: unknown mode {mode!r}")
    with open(dst, "wb") as f:
        f.write(bytes(data))
    return dst


def _corrupt_arrays(arrays: dict, component: str, seed: int) -> dict:
    """A copy of ``arrays`` whose ``component`` tensor has bit 7 flipped
    in an eighth of its words (at least 8), on the tensor's device."""
    a = arrays[component]
    flat = a.detach().cpu().numpy().reshape(-1).copy()
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, flat.size, size=max(8, flat.size // 8))
    flat[idx] ^= np.int32(1) << 7
    out = dict(arrays)
    out[component] = torch.from_numpy(flat.reshape(a.shape)).to(a.device)
    return out


def corrupt_tables(tables: dict, site: str, component: str = "t_ust",
                   seed: int = 0) -> dict:
    """A copy of a served ``lut_tables`` dict with one site's
    ``component`` slab bit-flipped: shapes and dtypes stay valid, the
    served *values* change (the silent corruption only a value-level probe,
    the ladder's bit-identity check against gather, can catch).  An entry
    with a kernel launch record gets a new one: a record points at its
    tensors, so the old one would still read the intact slab."""
    from repro_torch.kernels.lut_act import (
        MultiLaunch,
        entry_plan_record,
        stacked_record,
    )
    from .stacked import multi_site_stacked_entry

    tables = dict(tables)
    sites_d = dict(tables["sites"])
    entry = dict(sites_d[site])
    if "stacked" in entry:
        st = dict(entry["stacked"])
        st["arrays"] = _corrupt_arrays(st["arrays"], component, seed)
        if "k1_record" in st:
            st["k1_record"] = stacked_record(st)
        entry["stacked"] = st
    elif "multi" in entry:
        multi = dict(tables["multi"])
        multi["arrays"] = _corrupt_arrays(multi["arrays"], component, seed)
        if "k4_record" in multi:
            order = multi["meta"]["sites"]
            multi["site_records"] = {
                s: stacked_record(multi_site_stacked_entry(multi, s))
                for s in order}
            multi["k4_record"] = MultiLaunch(multi["site_records"], order)
        tables["multi"] = multi
    elif "layers" in entry:
        layers = [dict(e) for e in entry["layers"]]
        layers[0]["arrays"] = _corrupt_arrays(
            layers[0]["arrays"], component, seed)
        if "k1_record" in layers[0]:
            layers[0]["k1_record"] = entry_plan_record(layers[0])
        entry["layers"] = layers
    else:
        entry["arrays"] = _corrupt_arrays(entry["arrays"], component, seed)
        if "k1_record" in entry:
            entry["k1_record"] = entry_plan_record(entry)
    sites_d[site] = entry
    tables["sites"] = sites_d
    return tables


def corrupt_rung(ladder, rung: str, site: str, component: str = "t_ust",
                 seed: int = 0) -> None:
    """Corrupt one site's slab inside a
    :class:`~repro_torch.serve.degrade.DegradationLadder` rung cache (a
    flipped transfer in memory): the ladder's next revalidation probe must
    catch it by bit-identity against the gather rung."""
    ladder.set_rung_tables(
        rung, corrupt_tables(ladder.rung_tables(rung), site,
                             component=component, seed=seed))
