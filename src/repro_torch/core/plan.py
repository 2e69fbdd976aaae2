"""Compression-plan artifacts: the output of the ReducedLUT flow.

A plan is a serializable description of how a logical table is implemented:
either :class:`PlainPlan` (raw tabulation) or :class:`DecomposedPlan`
(Eq. 1 decomposition plus optional higher/lower-bit split).  Plans know
their analytical P-LUT cost, can reconstruct the full table (bit-exact with
what the emitted Verilog computes), and can export packed arrays for the
JAX/Pallas runtime evaluators.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np

from .bitutils import bits_for_count, bits_for_value
from .cost_model import adder_plut_cost, rom_plut_cost, shifter_plut_cost


@dataclasses.dataclass
class PlainPlan:
    """Uncompressed tabulation of the (possibly don't-care-filled) table."""

    values: np.ndarray
    w_in: int
    w_out: int
    name: str = "t"

    @property
    def kind(self) -> str:
        return "plain"

    def plut_cost(self) -> int:
        return rom_plut_cost(self.w_in, self.w_out)

    def table_bits(self) -> int:
        return (1 << self.w_in) * self.w_out

    def reconstruct(self) -> np.ndarray:
        return self.values.copy()

    def lookup_arrays(self) -> dict[str, np.ndarray]:
        return {"table": self.values.astype(np.int32)}


@dataclasses.dataclass
class DecomposedPlan:
    """Eq. (1) decomposition:
    ``hb(x) = (T_ust[{T_idx[x_hb], x_lb}] >> T_rsh[x_hb]) + T_bias[x_hb]``
    ``T(x) = {hb(x), T_lb[x]}``.
    """

    w_in: int
    w_out: int
    w_lb: int            # lower bits stored plain (0 => no split)
    l: int               # log2(sub-table length M)
    w_st: int            # residual bit-width stored in t_ust
    t_ust: np.ndarray    # (n_ust * M,) residual values
    t_idx: np.ndarray    # (n_sub,) unique-sub-table index per x_hb
    t_rsh: np.ndarray    # (n_sub,) right shift per x_hb
    t_bias: np.ndarray   # (n_sub,) bias per x_hb
    t_lb: np.ndarray | None = None  # (2**w_in,) plain low bits
    name: str = "t"

    @property
    def kind(self) -> str:
        return "decomposed"

    @property
    def m(self) -> int:
        return 1 << self.l

    @property
    def w_hb(self) -> int:
        return self.w_out - self.w_lb

    @property
    def n_sub(self) -> int:
        return self.t_idx.shape[0]

    @property
    def n_ust(self) -> int:
        return self.t_ust.shape[0] // self.m

    @property
    def idx_bits(self) -> int:
        return bits_for_count(self.n_ust)

    @property
    def rsh_bits(self) -> int:
        return bits_for_value(int(self.t_rsh.max(initial=0)))

    @property
    def bias_bits(self) -> int:
        return bits_for_value(int(self.t_bias.max(initial=0)))

    def component_costs(self) -> dict[str, int]:
        """Per-component analytical P-LUT costs (DESIGN.md SS2 model)."""
        q_hb = self.w_in - self.l  # sub-table-select input bits
        costs = {
            "t_ust": rom_plut_cost(self.idx_bits + self.l, self.w_st),
            "t_idx": rom_plut_cost(q_hb, self.idx_bits),
            "t_rsh": rom_plut_cost(q_hb, self.rsh_bits),
            "t_bias": rom_plut_cost(q_hb, self.bias_bits),
            "t_lb": rom_plut_cost(self.w_in, self.w_lb),
            "shifter": shifter_plut_cost(self.w_st, self.rsh_bits),
            "adder": adder_plut_cost(self.w_hb) if self.bias_bits > 0 else 0,
        }
        return costs

    def plut_cost(self) -> int:
        return sum(self.component_costs().values())

    def table_bits(self) -> int:
        q_hb = self.w_in - self.l
        return (
            self.t_ust.shape[0] * self.w_st
            + (1 << q_hb) * (self.idx_bits + self.rsh_bits + self.bias_bits)
            + (1 << self.w_in) * self.w_lb
        )

    def reconstruct(self) -> np.ndarray:
        """Full table as the hardware computes it (wrap to w_out bits)."""
        m = self.m
        x = np.arange(1 << self.w_in)
        x_hb = x >> self.l
        x_lb = x & (m - 1)
        ust_addr = self.t_idx[x_hb] * m + x_lb
        hb = (self.t_ust[ust_addr] >> self.t_rsh[x_hb]) + self.t_bias[x_hb]
        hb &= (1 << max(self.w_hb, 1)) - 1
        if self.w_lb > 0:
            assert self.t_lb is not None
            return (hb << self.w_lb) | self.t_lb
        return hb

    def lookup_arrays(self) -> dict[str, np.ndarray]:
        out = {
            "t_ust": self.t_ust.astype(np.int32),
            "t_idx": self.t_idx.astype(np.int32),
            "t_rsh": self.t_rsh.astype(np.int32),
            "t_bias": self.t_bias.astype(np.int32),
        }
        if self.t_lb is not None:
            out["t_lb"] = self.t_lb.astype(np.int32)
        return out


Plan = PlainPlan | DecomposedPlan


def save_plans(path: str, plans: list[Plan]) -> None:
    """Serialize a list of plans to a single ``.npz`` with a JSON manifest."""
    arrays: dict[str, np.ndarray] = {}
    manifest = []
    for i, p in enumerate(plans):
        if isinstance(p, PlainPlan):
            manifest.append({
                "kind": "plain", "w_in": p.w_in, "w_out": p.w_out,
                "name": p.name,
            })
            arrays[f"p{i}_values"] = p.values
        else:
            manifest.append({
                "kind": "decomposed", "w_in": p.w_in, "w_out": p.w_out,
                "w_lb": p.w_lb, "l": p.l, "w_st": p.w_st, "name": p.name,
            })
            arrays[f"p{i}_t_ust"] = p.t_ust
            arrays[f"p{i}_t_idx"] = p.t_idx
            arrays[f"p{i}_t_rsh"] = p.t_rsh
            arrays[f"p{i}_t_bias"] = p.t_bias
            if p.t_lb is not None:
                arrays[f"p{i}_t_lb"] = p.t_lb
    buf = io.BytesIO()
    np.savez_compressed(buf, manifest=json.dumps(manifest), **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_plans(path: str) -> list[Plan]:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        plans: list[Plan] = []
        for i, meta in enumerate(manifest):
            if meta["kind"] == "plain":
                plans.append(PlainPlan(
                    values=z[f"p{i}_values"], w_in=meta["w_in"],
                    w_out=meta["w_out"], name=meta["name"],
                ))
            else:
                plans.append(DecomposedPlan(
                    w_in=meta["w_in"], w_out=meta["w_out"],
                    w_lb=meta["w_lb"], l=meta["l"], w_st=meta["w_st"],
                    t_ust=z[f"p{i}_t_ust"], t_idx=z[f"p{i}_t_idx"],
                    t_rsh=z[f"p{i}_t_rsh"], t_bias=z[f"p{i}_t_bias"],
                    t_lb=z[f"p{i}_t_lb"] if f"p{i}_t_lb" in z.files else None,
                    name=meta["name"],
                ))
    return plans
