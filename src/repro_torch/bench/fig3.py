"""Paper Fig. 3: exiguity sweep — P-LUTs and test accuracy vs exiguity.

Counterpart of the reference's ``benchmarks/fig3.py``.
"""
from __future__ import annotations

from .common import bench_scale, compress_and_eval, get_trained, save_result

EXIGUITIES = (0, 10, 20, 50, 100, 150, 250, 400)


def run(model: str = "jsc-2l", scale: str | None = None, device=None,
        workers: int | None = None, out_dir=None) -> list[dict]:
    scale = bench_scale(scale)
    net = get_trained(model, scale, device)
    base = compress_and_eval(net, "baseline", None)
    rows = [{"model": model, "exiguity": "baseline", **base}]
    for ex in EXIGUITIES:
        r = compress_and_eval(net, "reducedlut", ex, workers=workers)
        rows.append({"model": model, "exiguity": ex, **r})
        print(f"  {model} exiguity={ex:>4d} pluts={r['pluts']:>6d} "
              f"test_acc={r['test_acc']:.4f}")
    save_result(f"fig3_{model}_{scale}", rows, out_dir)
    return rows
