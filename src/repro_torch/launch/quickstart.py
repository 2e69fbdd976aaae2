"""Quickstart: compress one lookup table with ReducedLUT, then evaluate it
on the device (counterpart of the reference's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda|cpu]

Builds a smooth 12-bit table with 60% don't cares, compares CompressedLUT
with ReducedLUT at exiguity 20 and 250 (analytical P-LUT costs), emits
Verilog, and runs 1024 lookups of every plan (the plain tabulation, the
CompressedLUT plan and both ReducedLUT plans) through
``kernels.lut_reconstruct`` (kernel K5 for a decomposed plan, K6 for a
plain one; the plain versions with ``--device cpu``): each equal to
``plan.reconstruct()`` and exact on every care entry.  (The reference's
quickstart evaluates the last plan only.)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (
    CompressConfig,
    PlainPlan,
    TableSpec,
    compress_table,
    plan_to_verilog,
    rom_baseline_cost,
    verify_care_exact,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import PlanArrays, launch_counts, lut_reconstruct


def run(device=None, log=print) -> dict:
    dev = resolve_device(device)
    spec = TableSpec.random(
        w_in=12, w_out=8, dontcare_frac=0.6, seed=7, smooth=True,
        name="quickstart",
    )
    log(f"table: 2^{spec.w_in} x {spec.w_out}b, "
        f"{spec.n_dontcare}/{spec.size} don't cares")
    plans = {"plain": PlainPlan(spec.values, spec.w_in, spec.w_out,
                                name=spec.name)}
    out = {"baseline": rom_baseline_cost(spec)}
    log(f"plain tabulation:      {out['baseline']:5d} P-LUTs")

    plans["compressedlut"] = compress_table(spec,
                                            CompressConfig(exiguity=None))
    out["compressedlut"] = plans["compressedlut"].plut_cost()
    log(f"CompressedLUT:         {out['compressedlut']:5d} P-LUTs "
        f"(no don't cares)")

    for ex in (20, 250):
        plan = compress_table(spec, CompressConfig(exiguity=ex))
        if not verify_care_exact(spec, plan):
            raise AssertionError(f"exiguity {ex}: a care entry differs")
        plans[f"reducedlut_{ex}"] = plan
        out[f"reducedlut_{ex}"] = plan.plut_cost()
        log(f"ReducedLUT (ex={ex:3d}):  {plan.plut_cost():5d} P-LUTs "
            f"({plan.kind})")

    verilog = plan_to_verilog(plan)
    out["verilog_lines"] = len(verilog.splitlines())
    log(f"\nVerilog: {out['verilog_lines']} lines (module llut_{spec.name})")

    xs = np.random.default_rng(0).integers(0, spec.size, 1024)
    x = torch.as_tensor(xs, dtype=torch.int32, device=dev)
    care = spec.care_mask()[xs]
    for name, plan in plans.items():
        got = lut_reconstruct(x, PlanArrays.from_plan(plan, device=dev))
        got = got.cpu().numpy()
        if not np.array_equal(got, plan.reconstruct()[xs]):
            raise AssertionError(f"{name}: lut_reconstruct differs from "
                                 f"plan.reconstruct()")
        if not (got[care] == spec.values[xs][care]).all():
            raise AssertionError(f"{name}: a care entry differs on "
                                 f"{dev.type}")
        log(f"{dev.type} eval of {name} ({plan.kind} plan): {xs.size} "
            f"lookups, care-exact=True")
    out["care_exact"] = True
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    out = run(args.device)
    print(f"kernel launches: {launch_counts()}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
