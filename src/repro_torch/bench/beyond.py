"""Beyond-paper core-algorithm variants.

Counterpart of the reference's ``benchmarks/beyond.py``.  Two extensions
the paper lists as future work / leaves unexplored:
  * ``bias_care_only``: compute each sub-table's bias from care entries
    only — don't-care entries no longer constrain the bias, giving the
    merge phase strictly more freedom.
  * ``merge_sweeps=2``: re-run the don't-care merge after the first sweep
    (freezing limits each sweep; a second pass catches newly-exposed
    matches).
"""
from __future__ import annotations

import time

from repro_torch.core import CompressConfig, compress_network
from repro_torch.lutnn import network_table_specs

from .common import (
    LB_CANDIDATES,
    M_CANDIDATES,
    bench_scale,
    get_trained,
    save_result,
)

VARIANTS = (
    ("reducedlut", dict(exiguity=250)),
    ("bias_care_only", dict(exiguity=250, bias_care_only=True)),
    ("two_sweeps", dict(exiguity=250, merge_sweeps=2)),
    ("both", dict(exiguity=250, bias_care_only=True, merge_sweeps=2)),
)


def run(model: str = "jsc-2l", scale: str | None = None, device=None,
        out_dir=None) -> list[dict]:
    scale = bench_scale(scale)
    net = get_trained(model, scale, device)
    specs = network_table_specs(net.tables, net.observed, net.cfg)
    rows = []
    for name, kw in VARIANTS:
        ccfg = CompressConfig(m_candidates=M_CANDIDATES,
                              lb_candidates=LB_CANDIDATES, **kw)
        t0 = time.time()
        plans = compress_network(specs, ccfg)
        cost = sum(p.plut_cost() for p in plans)
        rows.append({"model": model, "variant": name, "pluts": cost,
                     "seconds": round(time.time() - t0, 1)})
        print(f"  {model} {name:15s} pluts={cost}")
    save_result(f"beyond_{model}_{scale}", rows, out_dir)
    return rows
