"""The port's telemetry layer against the reference's ``obs`` package, on
the CPU: the metrics registry, the checksummed event log, the structured
logger, the report CLI, the engine's compression counters and the
don't-care drift monitor (``repro_torch.obs``, ``repro_torch.launch.obs``).

Both packages run side by side on the same calls and the same inputs
(made from a seed with numpy):

* the registry gives the same Prometheus text, snapshot and summary for
  the same sequence of calls (pure Python: exact);
* each package's ``read_events`` reads the other's log record for record,
  and both refuse the same damaged logs (a bit-flip, a missing header, a
  truncation, a spliced-out line); ``record_crc`` is equal on the same
  record;
* the two report CLIs print the same text from one log;
* the engine's counters and ``compress`` event equal the reference's for
  the same specs (every field but the seconds);
* ``DontCareMonitor.observe`` gives the reference's per-key hits and
  lookups.  The reference counts with one code rule op by op and another
  under ``jax.jit``: XLA rewrites the division by the constant span into
  a multiply by its float32 reciprocal, so on a bin edge of a span that
  is not a power of two the two forms disagree.  The port is held to the
  jitted form everywhere (its served steps are jitted), and to the op by
  op form wherever the two reference forms agree; the cases assert where
  they disagree.
"""
import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.calib import CalibrationSet as JCalibrationSet
from repro.core import TableSpec as JTableSpec
from repro.core.engine import PlanCache as JPlanCache
from repro.core.engine import compress_network_report as j_compress
from repro.ioutil import ArtifactError as JArtifactError
from repro.launch.obs import main as j_obs_main
from repro_torch import obs
from repro_torch.calib import CalibrationSet
from repro_torch.core import TableSpec
from repro_torch.core.engine import PlanCache, compress_network_report
from repro_torch.ioutil import ArtifactError
from repro_torch.launch.obs import main as obs_main
from repro_torch.obs import drift as obs_drift
from repro_torch.obs.log import Logger, as_logger, log
from repro_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    exponential_buckets,
)

PKGS = {"port": obs, "reference": jobs}


# =========================================================================
# metrics registry
# =========================================================================
def _seq_counters(reg):
    c = reg.counter("reqs_total", "requests")
    c.inc(site="mlp")
    c.inc(2, site="mlp")
    c.inc(0.5, site="ffn", backend="cuda")
    reg.counter("bare_total").inc()


def _seq_gauges(reg):
    g = reg.gauge("depth", "queue depth")
    g.set(5)
    g.set(2)
    g.inc(3.25, slot="1")
    reg.gauge("util").set(1 / 3)


def _seq_histograms(reg):
    h = reg.histogram("lat_s", "latency")
    for v in (1e-5, 1e-4, 0.00015, 0.002, 0.002, 3.5, 50.0, float("nan")):
        h.observe(v)
        h.observe(v * 2, kind="decomposed")
    small = reg.histogram("tiny", buckets=exponential_buckets(0.1, 2.0, 3))
    for v in (0.05, 0.1, 0.2, 0.3, 0.4) * 6 + (0.8,):
        small.observe(v)     # one overflow, below the p95 rank


def _seq_mixed(reg):
    _seq_histograms(reg)
    _seq_counters(reg)
    _seq_gauges(reg)
    reg.counter("reqs_total").inc(7, site="mlp")
    reg.histogram("lat_s").observe(0.01)


def _seq_random(reg):
    rng = np.random.default_rng(3)
    names = [f"m{i}" for i in range(4)]
    for _ in range(200):
        name = names[int(rng.integers(4))]
        labels = {"site": f"L{int(rng.integers(3))}/mlp"} \
            if rng.random() < 0.5 else {}
        kind = int(name[1:]) % 3
        if kind == 0:
            reg.counter(name).inc(float(rng.integers(1, 5)), **labels)
        elif kind == 1:
            reg.gauge(name).set(float(rng.normal()), **labels)
        else:
            reg.histogram(name).observe(float(rng.lognormal(-6, 3)),
                                        **labels)


SEQUENCES = {"empty": lambda reg: None, "counters": _seq_counters,
             "gauges": _seq_gauges, "histograms": _seq_histograms,
             "mixed": _seq_mixed, "random": _seq_random}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_registry_text_snapshot_and_summary_equal_reference(seq):
    from repro.obs.metrics import MetricsRegistry as JRegistry

    ours, ref = MetricsRegistry(), JRegistry()
    SEQUENCES[seq](ours)
    SEQUENCES[seq](ref)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    assert json.dumps(ours.snapshot()) == json.dumps(ref.snapshot())
    assert ours.summary() == ref.summary()


def test_overflow_quantile_and_infinite_sum_render():
    """Where a histogram's quantile lands in the overflow bucket, or a
    counter holds an infinity, the reference's ``_num`` raises
    (``int(inf)``); the port renders Prometheus's ``+Inf``.  Everything
    else about such a registry is the reference's."""
    from repro.obs.metrics import MetricsRegistry as JRegistry

    ours, ref = MetricsRegistry(), JRegistry()
    for reg in (ours, ref):
        for v in (0.5, 200.0, 300.0):
            reg.histogram("lat_s").observe(v)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    with pytest.raises(OverflowError):
        ref.summary()
    assert ours.summary() == "lat_s: n=3 p50<=+Inf p95<=+Inf"
    for reg in (ours, ref):
        reg.counter("big_total").inc(float("inf"))
    with pytest.raises(OverflowError):
        ref.render_prometheus()
    assert "big_total +Inf" in ours.render_prometheus()


def test_registry_errors_as_the_reference():
    from repro.obs.metrics import MetricsRegistry as JRegistry

    for reg in (MetricsRegistry(), JRegistry()):
        c = reg.counter("reqs_total", "requests")
        c.inc(site="mlp")
        assert reg.counter("reqs_total") is c
        with pytest.raises(ValueError, match="negative"):
            c.inc(-1)
        with pytest.raises(ValueError, match="already registered"):
            reg.histogram("reqs_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("reqs_total")
    with pytest.raises(ValueError, match="exponential_buckets"):
        exponential_buckets(0.0, 2.0, 3)
    with pytest.raises(ValueError, match="sorted"):
        Histogram("h", buckets=(2.0, 1.0))


def test_histogram_buckets_and_percentiles():
    h = Histogram("lat", buckets=exponential_buckets(0.001, 2.0, 10))
    assert h.percentile(0.5) == 0.0  # empty: defined, not NaN
    for v in (0.001, 0.002, 0.002, 0.004, 100.0):
        h.observe(v)
    h.observe(float("nan"))  # skipped
    assert h.count() == 5
    assert h.percentile(0.5) == 0.002
    assert h.percentile(1.0) == float("inf")  # overflow bucket
    snap = h.snapshot()[""]
    assert snap["count"] == 5 and snap["p95"] is None  # inf -> JSON null


# =========================================================================
# event log
# =========================================================================
def _write_log(pkg, path, *, sample=1):
    ev = pkg.EventLog(path, sample=sample)
    ev.emit("hello", n=1, value=123, note="ünïcode", ratio=1 / 3,
            nested={"a": [1, 2.5, None]}, obj=object.__name__)
    with ev.span("outer", tag="t"):
        ev.emit("inner")
        with ev.span("nested"):
            for i in range(7):
                ev.emit("tick", sampled=True, tick=i)
    ev.emit("drift", site="L0/mlp", lookups=10, dontcare_hits=1,
            served_dontcare_frac=0.1, calib_dontcare_frac=None,
            excess=0.1)
    ev.close(metrics={"things_total": {"": 3}})
    return ev


def _strip_time(recs):
    return [{k: v for k, v in r.items()
             if k not in ("t", "crc", "wall_time", "dur_s")} for r in recs]


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_event_log_read_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "run.jsonl")
    ev = _write_log(PKGS[writer], path, sample=3)
    recs = PKGS[reader].read_events(path)
    assert recs == ev.records
    assert recs[0]["schema"] == obs.OBS_SCHEMA == jobs.OBS_SCHEMA
    assert recs[-1]["n_records"] == len(recs)
    for r in recs:
        assert r["crc"] == obs.record_crc(r) == jobs.record_crc(r)


def test_event_logs_of_both_packages_agree_record_for_record(tmp_path):
    """The same calls give the same records but their clocks."""
    a = _write_log(obs, str(tmp_path / "a.jsonl"), sample=3)
    b = _write_log(jobs, str(tmp_path / "b.jsonl"), sample=3)
    assert _strip_time(a.records) == _strip_time(b.records)


@pytest.mark.parametrize("rec", [
    {"seq": 0, "t": 0.0, "event": "obs_start", "schema": "repro-obs/v1"},
    {"seq": 3, "t": 1.25, "event": "x", "f": 1e-300, "g": -0.0,
     "s": "tab\tquote\"", "u": "é", "l": [1, {"b": 2, "a": 1}]},
    {"event": "y", "crc": 12345, "n": None, "big": 2 ** 62},
])
def test_record_crc_equal(rec):
    assert obs.record_crc(rec) == jobs.record_crc(rec)
    body = dict(rec, crc=0)
    assert obs.record_crc(body) == obs.record_crc(rec)


def test_event_log_sampling_accounts_for_drops():
    for pkg in (obs, jobs):
        ev = pkg.EventLog(sample=3)
        for _ in range(10):
            ev.emit("tick", sampled=True)
            ev.emit("swap")  # unsampled events are never thinned
        ev.close()
        ticks = [r for r in ev.records if r["event"] == "tick"]
        swaps = [r for r in ev.records if r["event"] == "swap"]
        assert len(swaps) == 10
        assert len(ticks) == 4  # occurrences 0, 3, 6, 9
        assert sum(r.get("sampled_dropped", 0) for r in ticks) == 10 - 4
        assert all(r["sampled_every"] == 3
                   for r in ticks if "sampled_dropped" in r)
    a, b = obs.EventLog(sample=4), jobs.EventLog(sample=4)
    for ev in (a, b):
        for i in range(9):
            ev.emit("tick", sampled=True, i=i)
        ev.close()
    assert _strip_time(a.records) == _strip_time(b.records)


def _damage(lines, mode):
    if mode == "bitflip":
        return [l.replace("123", "124") for l in lines]
    if mode == "no_header":
        return lines[1:]
    if mode == "truncated":
        return lines[:-1]
    if mode == "spliced":
        return lines[:1] + lines[2:]
    if mode == "cut_line":
        return ["\n".join(lines)[:-30]]
    raise ValueError(mode)


DAMAGE = {"bitflip": "CRC mismatch", "no_header": "obs header",
          "truncated": "no obs_end footer", "spliced": "truncated or spliced",
          "cut_line": "not valid JSON"}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("mode", sorted(DAMAGE))
def test_damaged_logs_refused_by_both_readers(tmp_path, writer, mode):
    path = str(tmp_path / "run.jsonl")
    _write_log(PKGS[writer], path)
    lines = open(path).read().splitlines()
    bad = str(tmp_path / f"{mode}.jsonl")
    open(bad, "w").write("\n".join(_damage(lines, mode)) + "\n")
    for reader, err in ((obs, ArtifactError), (jobs, JArtifactError)):
        with pytest.raises(err, match=DAMAGE[mode]):
            reader.read_events(bad)
    if mode == "truncated":   # a crashed run's partial log, inspected
        assert (len(obs.read_events(bad, strict=False))
                == len(jobs.read_events(bad, strict=False))
                == len(lines) - 1)


def test_event_log_roundtrip_spans(tmp_path):
    path = str(tmp_path / "run.jsonl")
    ev = obs.EventLog(path)
    ev.emit("hello", n=1)
    with ev.span("outer", tag="t"):
        ev.emit("inner")
        with ev.span("nested"):
            pass
    ev.close(note="done")
    records = obs.read_events(path)
    by_event = {}
    for r in records:
        by_event.setdefault(r["event"], []).append(r)
    outer = by_event["span_begin"][0]
    assert by_event["inner"][0]["span"] == outer["span_id"]
    nested = by_event["span_begin"][1]
    assert nested["parent"] == outer["span_id"]
    ends = {r["span_id"]: r for r in by_event["span_end"]}
    assert ends[outer["span_id"]]["dur_s"] >= 0
    assert [r["seq"] for r in records] == list(range(len(records)))
    assert records[-1]["note"] == "done"


# =========================================================================
# logger, telemetry context
# =========================================================================
def test_structured_logger_mirrors_to_events(capsys):
    log.info("plain", "no telemetry active")  # print-only, must not raise
    tel = obs.Telemetry(events=obs.EventLog())
    lines = []
    with tel:
        log.info("prefill", "prefill 2x8: 0.5s", seconds=0.5)
        log.error("boom", "something failed")
        as_logger(lines.append).warn("quiet", "to a callable", n=2)
        log.info("fields_only", n=3)
    out = capsys.readouterr()
    assert "prefill 2x8: 0.5s" in out.out
    assert "something failed" in out.err
    assert "to a callable" not in out.out + out.err
    assert lines == ["to a callable"]
    recs = {r["event"]: r for r in tel.events.records}
    assert recs["prefill"]["seconds"] == 0.5
    assert recs["prefill"]["level"] == "info"
    assert recs["boom"]["level"] == "error"
    assert recs["quiet"]["level"] == "warn" and recs["quiet"]["n"] == 2
    assert recs["fields_only"]["msg"] == "n=3"
    assert as_logger(None) is log and as_logger(print) is log
    lg = Logger(lines.append)
    assert as_logger(lg) is lg


def test_telemetry_footer_and_prometheus_on_every_exit(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tel = obs.Telemetry(events=obs.EventLog(path), prom_path=path + ".prom")
    with pytest.raises(SystemExit):
        with tel:
            obs.count("things_total", 3)
            obs.observe("lat_s", 0.25)
            obs.gauge("depth", 2, site="mlp")
            raise SystemExit(2)
    records = obs.read_events(path)  # footer present despite SystemExit
    metrics = records[-1]["metrics"]
    assert metrics["things_total"][""] == 3
    assert metrics["lat_s"][""]["count"] == 1
    assert metrics["depth"]['{site="mlp"}'] == 2
    assert "things_total 3" in open(path + ".prom").read()
    assert not obs.telemetry_active() and obs.current() is None


def test_helpers_are_no_ops_without_telemetry():
    obs.count("x_total")
    obs.gauge("g", 1.0)
    obs.observe("h", 0.1)
    obs.event("e", a=1)
    obs.kernel_launch("cuda:lut_act_stacked")
    with obs.span("s"):
        pass
    assert obs.current() is None


def test_kernel_launch_counter_by_backend_and_kernel():
    from repro_torch.kernels import ops

    with obs.Telemetry() as tel:
        obs.kernel_launch("cuda:lut_act_stacked", 3)
        ops.note_launch("gather:lut_act")
        with ops.recording() as tally:
            ops.note_launch("cuda:fused_matmul_lut", 2)
        ops.note_launches(tally)
        ops.note_launches(tally)
    c = tel.registry.counter("kernel_launches_total")
    assert c.value(backend="cuda", kernel="lut_act_stacked") == 3
    assert c.value(backend="gather", kernel="lut_act") == 1
    assert c.value(backend="cuda", kernel="fused_matmul_lut") == 4
    assert tally == {"cuda:fused_matmul_lut": 2}


# =========================================================================
# report CLI
# =========================================================================
def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("flags", [[], ["--limit", "3"], ["--limit", "0"],
                                   ["--events", "hello,tick"]])
def test_report_cli_prints_the_reference_report(tmp_path, writer, flags):
    pkg = PKGS[writer]
    path = str(tmp_path / "r.jsonl")
    tel = pkg.Telemetry(events=pkg.EventLog(path, sample=2))
    with tel:
        with pkg.span("work"):
            pkg.event("step", n=1)
            for i in range(5):
                pkg.event("tick", sampled=True, tick=i)
        tel.event("drift", site="L0/mlp", lookups=10, dontcare_hits=1,
                  served_dontcare_frac=0.1, calib_dontcare_frac=0.0,
                  excess=0.1)
        tel.event("drift", site="mlp", lookups=4, dontcare_hits=0,
                  served_dontcare_frac=0.0, calib_dontcare_frac=None,
                  excess=0.0)
        pkg.count("reqs_total", 2, site="mlp")
        pkg.observe("lat_s", 0.003)
    rc, out, _ = _cli(obs_main, [path] + flags)
    jrc, jout, _ = _cli(j_obs_main, [path] + flags)
    assert rc == jrc == 0
    assert out == jout
    assert "== timeline ==" in out and "L0/mlp" in out


@pytest.mark.parametrize("mode", ["truncated", "cut_line"])
def test_report_cli_refuses_damaged_logs_as_the_reference(tmp_path, mode):
    path = str(tmp_path / "r.jsonl")
    _write_log(obs, path)
    lines = open(path).read().splitlines()
    open(path, "w").write("\n".join(_damage(lines, mode)) + "\n")
    rc, out, err = _cli(obs_main, [path])
    jrc, jout, _ = _cli(j_obs_main, [path])
    assert rc == jrc == 1 and out == jout == "" and "error:" in err
    if mode == "truncated":   # --no-strict inspects the partial log
        rc, out, _ = _cli(obs_main, [path, "--no-strict"])
        jrc, jout, _ = _cli(j_obs_main, [path, "--no-strict"])
        assert rc == jrc == 0 and out == jout and "partial log" in out


# =========================================================================
# engine compression counters
# =========================================================================
def _specs(mod, n, dup):
    rng = np.random.default_rng(11)
    specs = []
    for i in range(n):
        vals = np.sort(rng.integers(0, 64, 64)).astype(np.int64)
        care = rng.random(64) < 0.7
        specs.append(mod(vals, 6, 6, care, f"t{i}"))
    return specs + [dataclasses.replace(specs[0], name=f"dup{k}")
                    for k in range(dup)]


@pytest.mark.parametrize("dup,cached", [(0, False), (2, False), (2, True)])
def test_engine_compression_counters_equal_reference(dup, cached):
    def run(pkg, spec_cls, compress, cache_cls):
        cache = cache_cls() if cached else None
        with pkg.Telemetry(events=pkg.EventLog()) as tel:
            for _ in range(2 if cached else 1):
                compress(_specs(spec_cls, 3, dup), workers=1, cache=cache)
        snap = tel.registry.snapshot()
        hist = snap.pop("compress_table_seconds")
        evs = [{k: v for k, v in r.items() if k not in ("seq", "t", "crc",
                                                        "seconds")}
               for r in tel.events.records if r["event"] == "compress"]
        return snap, {k: v["count"] for k, v in hist.items()}, evs

    ours = run(obs, TableSpec, compress_network_report, PlanCache)
    ref = run(jobs, JTableSpec, j_compress, JPlanCache)
    assert ours == ref
    assert ours[0]["compress_tables_total"][""] == (3 + dup) * (
        2 if cached else 1)


def test_engine_without_telemetry_records_nothing():
    rep = compress_network_report(_specs(TableSpec, 2, 1), workers=1)
    assert len(rep.tables) == 3 and obs.current() is None


# =========================================================================
# don't-care monitor
# =========================================================================
def _calib(pkg_cls, masks, *, w_in=4, x_lo=-8.0, x_hi=8.0, hists=None):
    return pkg_cls({k: np.asarray(m, bool) for k, m in masks.items()},
                   w_in=w_in, x_lo=x_lo, x_hi=x_hi, hists=hists)


def _toy_masks(w_in=4):
    n = 1 << w_in
    mask = np.zeros(n, bool)
    mask[: n // 2] = True
    return {"mlp": mask}


def _edge_values(x_lo, x_hi, w_in):
    """Every bin edge and half-bin of the quantizer, one float32 ulp
    either side, the domain's ends and points past them."""
    levels = (1 << w_in) - 1
    span = np.float32(x_hi - x_lo)
    k = np.arange(levels + 1, dtype=np.float64)
    half = (np.float32(x_lo) + ((k + 0.5) / levels) * span).astype(
        np.float32)
    edge = (np.float32(x_lo) + (k / levels) * span).astype(np.float32)
    vals = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(-np.inf)), edge,
        np.float32([x_lo, x_hi, x_lo - 1, x_hi + 1, 0.0, -0.0])])
    return vals.astype(np.float32)


def _rng_masks(keys, n, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.random(n) < 0.6 for k in keys}


def _case(name):
    """``(masks, calib kwargs, observations [(site, layer, x float32)],
    dtype)`` of one monitor case."""
    rng = np.random.default_rng(5)
    if name in ("edges_pow2", "edges_span12", "edges_span_odd"):
        x_lo, x_hi = {"edges_pow2": (-8.0, 8.0),
                      "edges_span12": (-6.0, 6.0),
                      "edges_span_odd": (-2.7, 3.9)}[name]
        w_in = 6
        masks = _rng_masks(["L0/mlp", "L1/mlp"], 1 << w_in)
        x = _edge_values(x_lo, x_hi, w_in)
        return (masks, dict(w_in=w_in, x_lo=x_lo, x_hi=x_hi),
                [("mlp", 0, x), ("mlp", 1, x[::-1].copy())], "float32")
    if name == "rope_domain":   # the site's own domain [0, 2 pi]
        w_in = 8
        masks = _rng_masks(["L0/rope", "L2/rope"], 1 << w_in)
        x = _edge_values(0.0, 2 * math.pi, w_in)
        return (masks, dict(w_in=w_in),
                [("rope", 0, x), ("rope", 2, x), ("rope", 1, x)],
                "float32")
    if name == "nonfinite":
        x = np.float32([2.0, np.inf, -np.inf, np.nan, 3.0, -7.9, 8.5])
        return (_toy_masks(), {}, [("mlp", None, x),
                                   ("mlp", None, np.float32([np.nan]))],
                "float32")
    if name == "bf16":
        x = rng.normal(size=(3, 50)).astype(np.float32) * 4
        x = torch.from_numpy(x).bfloat16().float().numpy()
        masks = _rng_masks(["L0/mlp", "L1/mlp"], 256)
        return (masks, dict(w_in=8), [("mlp", 0, x), ("mlp", 1, x * 0.5)],
                "bfloat16")
    if name == "layer_past_stack":
        masks = _rng_masks(["L0/mlp", "L1/mlp"], 64)
        x = rng.uniform(-9, 9, 300).astype(np.float32)
        return (masks, dict(w_in=6),
                [("mlp", 1, x), ("mlp", 2, x), ("mlp", 7, x)], "float32")
    if name == "missing_layers":
        masks = _rng_masks(["L0/mlp", "L3/mlp"], 64)
        x = rng.uniform(-8, 8, 300).astype(np.float32)
        return (masks, dict(w_in=6),
                [("mlp", l, x) for l in range(4)], "float32")
    if name == "layer_agnostic":
        masks = _rng_masks(["L0/mlp", "L1/mlp", "mlp", "L0/expert"], 64)
        masks["logit_softcap"] = np.arange(64) % 3 > 0
        x = rng.uniform(-8, 8, 300).astype(np.float32)
        return (masks, dict(w_in=6),
                [("mlp", None, x), ("mlp", 0, x), ("logit_softcap", None, x),
                 ("logit_softcap", 3, x), ("expert", None, x),
                 ("ffn", 0, x)], "float32")
    raise ValueError(name)


MONITOR_CASES = ["edges_pow2", "edges_span12", "edges_span_odd",
                 "rope_domain", "nonfinite", "bf16", "layer_past_stack",
                 "missing_layers", "layer_agnostic"]
# the cases where the reference's op-by-op and jitted codes differ on some
# bin edge (spans that are not powers of two; the rope domain's 2 pi at
# w_in 8 happens to give equal codes)
JIT_DIFFERS = {"edges_span12", "edges_span_odd"}


def _reference_counts(masks, kw, observations, dtype, *, jit):
    mon = jobs.DontCareMonitor(_calib(JCalibrationSet, masks, **kw))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for site, layer, x in observations:
        xj = jnp.asarray(x).astype(jdt)
        if jit:
            lyr = None if layer is None else jnp.asarray(layer, jnp.int32)
            jax.jit(lambda v, l, _s=site, _n=layer is None: (
                mon.observe(_s, None if _n else l, v), v)[1])(xj, lyr)
        else:
            mon.observe(site, layer, xj)
    mon.flush()
    return dict(mon.hits), dict(mon.lookups)


@pytest.mark.parametrize("case", MONITOR_CASES)
def test_monitor_counts_equal_reference(case):
    masks, kw, observations, dtype = _case(case)
    mon = obs.DontCareMonitor(_calib(CalibrationSet, masks, **kw),
                              device="cpu")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for site, layer, x in observations:
        mon.observe(site, layer, torch.from_numpy(x).to(tdt))
    got = (mon.hits, mon.lookups)
    jitted = _reference_counts(masks, kw, observations, dtype, jit=True)
    eager = _reference_counts(masks, kw, observations, dtype, jit=False)
    assert got == jitted
    assert got[1] == eager[1]          # lookups never depend on the codes
    if case in JIT_DIFFERS:
        assert eager[0] != jitted[0], "the reference forms agree here"
    else:
        assert got == eager


def test_monitor_counts_dontcare_hits_and_drift_rows():
    hist = np.zeros(16, np.int64)
    hist[:8] = 10
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks(),
                                     hists={"mlp": hist}), device="cpu")
    care = torch.linspace(-7.5, -1.0, 20)
    dontcare = torch.linspace(1.0, 7.5, 20)
    mon.observe("mlp", None, care)
    assert mon.hits["mlp"] == 0 and mon.lookups["mlp"] == 20
    mon.observe("mlp", None, dontcare)
    assert mon.hits["mlp"] == 20 and mon.lookups["mlp"] == 40
    row = mon.drift()["mlp"]
    jmon = jobs.DontCareMonitor(_calib(JCalibrationSet, _toy_masks(),
                                       hists={"mlp": hist}))
    jmon.observe("mlp", None, jnp.asarray(care.numpy()))
    jmon.observe("mlp", None, jnp.asarray(dontcare.numpy()))
    assert mon.drift() == jmon.drift()
    assert mon.summary() == jmon.summary()
    assert row["served_dontcare_frac"] == 0.5 and row["excess"] == 0.5
    assert row["calib_dontcare_frac"] == 0.0


def test_monitor_key_with_no_finite_element_reports_zero_lookups():
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks()),
                              device="cpu")
    mon.observe("mlp", None, torch.tensor([float("nan"), float("inf")]))
    jmon = jobs.DontCareMonitor(_calib(JCalibrationSet, _toy_masks()))
    jmon.observe("mlp", None, jnp.asarray([jnp.nan, jnp.inf]))
    assert mon.lookups == dict(jmon.lookups) == {"mlp": 0}
    assert mon.drift() == jmon.drift()


def test_monitor_refuses_wrong_device_and_lutnn_calibration():
    with pytest.raises(ValueError, match="w_in=None"):
        obs.DontCareMonitor(CalibrationSet({"L0/n0": np.ones(4, bool)}),
                            device="cpu")
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks()),
                              device="meta")
    with pytest.raises(ValueError, match="counts on meta"):
        mon.observe("mlp", None, torch.zeros(4))


def test_monitor_output_passthrough_and_unknown_sites():
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks()),
                              device="cpu")
    x = torch.linspace(-6.0, 6.0, 64)
    fn = mon.wrap("mlp", None, torch.tanh)
    with mon:
        y = fn(x)
    assert torch.equal(y, torch.tanh(x))
    assert mon.lookups["mlp"] == 64
    assert mon.wrap("rope", None, torch.tanh) is torch.tanh
    mon.observe("rope", 0, x)          # unwanted: nothing counted
    assert set(mon.lookups) == {"mlp"}


def test_suppressed_hides_monitor():
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks()),
                              device="cpu")
    with mon:
        assert obs.monitor_active() and obs_drift.current() is mon
        with obs.suppressed():
            assert not obs.monitor_active()
            assert obs_drift.current() is None
        assert obs.monitor_active()
    assert not obs.monitor_active()


def test_monitor_snapshot_and_restore_counts():
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _rng_masks(
        ["L0/mlp", "L1/mlp"], 16)), device="cpu")
    x = torch.linspace(-8, 8, 33)
    mon.observe("mlp", 0, x)
    before = mon.counts()
    snap = mon.snapshot_counts()
    mon.observe("mlp", 0, x)
    mon.observe("mlp", 1, x)       # a key first seen after the snapshot
    assert set(mon.lookups) == {"L0/mlp", "L1/mlp"}
    mon.restore_counts(snap)
    assert mon.counts() == before and set(mon.lookups) == {"L0/mlp"}


def test_telemetry_exports_drift_rows_and_gauges():
    mon = obs.DontCareMonitor(_calib(CalibrationSet, _toy_masks()),
                              device="cpu")
    tel = obs.Telemetry(events=obs.EventLog(), monitor=mon)
    with tel:
        assert obs_drift.current() is mon
        mon.observe("mlp", None, torch.linspace(-8, 8, 10))
    assert obs_drift.current() is None
    drift = [r for r in tel.events.records if r["event"] == "drift"]
    assert [r["site"] for r in drift] == ["mlp"]
    assert drift[0]["lookups"] == 10
    assert tel.registry.gauge("lut_dontcare_served_frac").value(
        site="mlp") == drift[0]["served_dontcare_frac"]
