"""Verilog emission for compression plans (paper SS4.2 final step).

The emitted module computes exactly what ``plan.reconstruct()`` computes:
component ROMs as ``case`` tables, the Eq. (1) shift-add recombination, and
the higher/lower-bit concatenation.  Emission exists for fidelity with the
paper's toolflow; all accuracy evaluation in this repo runs on the
bit-exact array reconstruction (same function, no synthesis required).

Own copy of the reference's ``core/verilog.py``: the text is
byte-identical to the reference's for the same plan.
"""
from __future__ import annotations

import numpy as np

from .plan import DecomposedPlan, Plan, PlainPlan


def _rom(name: str, addr_bits: int, data_bits: int, values: np.ndarray) -> str:
    if data_bits == 0:
        return ""
    lines = [
        f"module {name} (",
        f"    input  wire [{max(addr_bits - 1, 0)}:0] addr,",
        f"    output reg  [{data_bits - 1}:0] data",
        ");",
        "    always @(*) begin",
        "        case (addr)",
    ]
    for a, v in enumerate(values.tolist()):
        lines.append(
            f"            {addr_bits}'d{a}: data = {data_bits}'d{int(v)};"
        )
    lines += [
        f"            default: data = {data_bits}'d0;",
        "        endcase",
        "    end",
        "endmodule",
        "",
    ]
    return "\n".join(lines)


def plan_to_verilog(plan: Plan, module: str | None = None) -> str:
    """Emit a self-contained synthesizable module for one plan."""
    module = module or f"llut_{plan.name}"
    if isinstance(plan, PlainPlan):
        return _rom(module, plan.w_in, plan.w_out, plan.values)

    assert isinstance(plan, DecomposedPlan)
    parts: list[str] = []
    hb_addr = plan.w_in - plan.l
    parts.append(_rom(f"{module}_ust", plan.idx_bits + plan.l, plan.w_st,
                      plan.t_ust))
    parts.append(_rom(f"{module}_idx", hb_addr, plan.idx_bits, plan.t_idx))
    if plan.rsh_bits > 0:
        parts.append(_rom(f"{module}_rsh", hb_addr, plan.rsh_bits, plan.t_rsh))
    if plan.bias_bits > 0:
        parts.append(_rom(f"{module}_bias", hb_addr, plan.bias_bits,
                          plan.t_bias))
    if plan.w_lb > 0:
        parts.append(_rom(f"{module}_lb", plan.w_in, plan.w_lb, plan.t_lb))

    w = plan.w_out
    body = [
        f"module {module} (",
        f"    input  wire [{plan.w_in - 1}:0] x,",
        f"    output wire [{w - 1}:0] y",
        ");",
        f"    wire [{max(hb_addr - 1, 0)}:0] x_hb = x[{plan.w_in - 1}:{plan.l}];",
        f"    wire [{max(plan.l - 1, 0)}:0] x_lb = x[{plan.l - 1}:0];",
        f"    wire [{plan.w_st - 1}:0] ust_q;",
    ]
    if plan.idx_bits > 0:
        body += [
            f"    wire [{plan.idx_bits - 1}:0] idx_q;",
            f"    {module}_idx u_idx (.addr(x_hb), .data(idx_q));",
            f"    {module}_ust u_ust (.addr({{idx_q, x_lb}}), .data(ust_q));",
        ]
    else:
        body.append(f"    {module}_ust u_ust (.addr(x_lb), .data(ust_q));")
    shifted = "ust_q"
    if plan.rsh_bits > 0:
        body += [
            f"    wire [{plan.rsh_bits - 1}:0] rsh_q;",
            f"    {module}_rsh u_rsh (.addr(x_hb), .data(rsh_q));",
            f"    wire [{plan.w_st - 1}:0] sh_q = ust_q >> rsh_q;",
        ]
        shifted = "sh_q"
    hb_expr = shifted
    if plan.bias_bits > 0:
        body += [
            f"    wire [{plan.bias_bits - 1}:0] bias_q;",
            f"    {module}_bias u_bias (.addr(x_hb), .data(bias_q));",
            f"    wire [{plan.w_hb - 1}:0] hb_q = {shifted} + bias_q;",
        ]
        hb_expr = "hb_q"
    else:
        body.append(f"    wire [{plan.w_hb - 1}:0] hb_q = {shifted};")
        hb_expr = "hb_q"
    if plan.w_lb > 0:
        body += [
            f"    wire [{plan.w_lb - 1}:0] lb_q;",
            f"    {module}_lb u_lb (.addr(x), .data(lb_q));",
            f"    assign y = {{{hb_expr}, lb_q}};",
        ]
    else:
        body.append(f"    assign y = {hb_expr};")
    body += ["endmodule", ""]
    parts.append("\n".join(body))
    return "\n".join(p for p in parts if p)


def network_to_verilog(plans: list[Plan], top: str = "lut_network") -> str:
    """Emit all L-LUT modules of a network plus a pass-through top stub."""
    chunks = [plan_to_verilog(p) for p in plans]
    return "\n".join(chunks)
