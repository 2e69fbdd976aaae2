"""The port's paper sweeps (``repro_torch.bench``) against the reference's
``benchmarks/`` on the CPU, on one trained network.

The reference trains the tiny LUT-NN of ``tests/test_torch_lutnn.py``
once; each package's cache is seeded with it (the port's tables, wiring
and masks carried across as CPU tensors), so neither package trains, and
every Table 2 row, Fig. 3 point and beyond-paper variant must be equal,
down to the tables each accuracy is measured on.  Compression runs in
process (``REPRO_BENCH_WORKERS=1``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import beyond as j_beyond
from benchmarks import common as j_common
from benchmarks import fig3 as j_fig3
from benchmarks import table2 as j_table2
from repro.data import make_jsc as j_make_jsc
from repro.data import make_mnist_like as j_make_mnist
from repro.lutnn import extract_tables as j_extract
from repro.lutnn import mark_observed as j_mark
from repro.lutnn import table_accuracy as j_accuracy
from repro.lutnn import train_lutnn as j_train
from repro.lutnn.model import LUTNNConfig as JConfig
from repro_torch.bench import beyond, common, fig3, table2
from repro_torch.bench import run as bench_run
from repro_torch.data import make_jsc, make_mnist_like
from repro_torch.lutnn import device_tables, table_accuracy
from repro_torch.lutnn.model import LUTNNConfig as TConfig

TINY = dict(name="tiny", n_inputs=16, layer_sizes=(12, 5), beta=3, fanin=3,
            beta0=3, fanin0=3, seed=0)
SCALE = "small"          # the reference's default bench scale
# the compressed rows' keys that must be equal (seconds are not)
ROW_KEYS = ("model", "method", "exiguity", "pluts", "test_acc", "train_acc",
            "workers", "n_decomposed", "eliminated", "vs_baseline",
            "vs_compressedlut", "scale")


@pytest.fixture(scope="module")
def nets():
    """The reference's trained tiny net as each package's ``TrainedNet``."""
    jcfg = JConfig(**TINY)
    data = j_make_jsc(3000, 800, seed=1)
    xtr, ytr, xte, yte = data
    params, conn, _ = j_train(jcfg, *data, epochs=6)
    tables = j_extract(params, jcfg)
    observed = j_mark(tables, conn, jcfg, xtr)
    jnet = j_common.TrainedNet(
        cfg=jcfg, conn=conn, tables=tables, observed=observed, data=data,
        test_acc=j_accuracy(tables, conn, jcfg, xte, yte),
        train_acc=j_accuracy(tables, conn, jcfg, xtr, ytr))
    tcfg = TConfig(**TINY)
    tconn, ttab = device_tables(conn, "cpu"), device_tables(tables, "cpu")
    tnet = common.TrainedNet(
        cfg=tcfg, conn=tconn, tables=ttab,
        observed=[torch.as_tensor(o) for o in observed], data=data,
        test_acc=table_accuracy(ttab, tconn, tcfg, xte, yte),
        train_acc=table_accuracy(ttab, tconn, tcfg, xtr, ytr))
    return jnet, tnet


def _seed_caches(mp, nets, tmp):
    jnet, tnet = nets
    mp.setenv("REPRO_BENCH_WORKERS", "1")
    mp.setenv("REPRO_BENCH_SCALE", SCALE)
    mp.setenv("REPRO_COMPRESS_WORKERS", "1")
    mp.setattr(j_common, "EXP_DIR", str(tmp / "reference"))
    mp.setitem(j_common._CACHE, ("tiny", SCALE), jnet)
    mp.setitem(common._CACHE, ("tiny", SCALE, "cpu"), tnet)


def _spy(mp, module, name, record, convert):
    """Wrap ``module.name`` so that each call appends ``convert(args,
    result)`` to ``record``."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        record.append(convert(args, out))
        return out

    mp.setattr(module, name, spy)


def _tables(args, out):
    return [np.asarray(t.numpy() if torch.is_tensor(t) else t)
            for t in args[0]]


def _costs(args, out):
    plans = out.plans if hasattr(out, "plans") else out
    return [p.plut_cost() for p in plans]


@pytest.fixture(scope="module")
def runs(nets, tmp_path_factory):
    """Table 2 (with its timing), Fig. 3 and the variants, once in each
    package, with the tables every accuracy was measured on and the
    timing section's per-table costs recorded."""
    tmp = tmp_path_factory.mktemp("bench")
    rec = {k: [] for k in ("j_tabs", "t_tabs", "j_serial", "t_serial",
                           "j_engine", "t_engine")}
    with pytest.MonkeyPatch.context() as mp:
        _seed_caches(mp, nets, tmp)
        _spy(mp, j_common, "table_accuracy", rec["j_tabs"], _tables)
        _spy(mp, common, "table_accuracy", rec["t_tabs"], _tables)
        for mod, tag in ((j_table2, "j"), (table2, "t")):
            _spy(mp, mod, "compress_network_serial", rec[f"{tag}_serial"],
                 _costs)
            _spy(mp, mod, "compress_network_report", rec[f"{tag}_engine"],
                 _costs)
        out = {
            "j_table2": j_table2.run(models=("tiny",)),
            "t_table2": table2.run(models=("tiny",), device="cpu",
                                   out_dir=tmp / "port"),
            "j_fig3": j_fig3.run("tiny"),
            "t_fig3": fig3.run("tiny", device="cpu", out_dir=tmp / "port"),
            "j_beyond": j_beyond.run("tiny"),
            "t_beyond": beyond.run("tiny", device="cpu",
                                   out_dir=tmp / "port"),
        }
    return dict(out, rec=rec, tmp=tmp)


def _row(r):
    return {k: r[k] for k in ROW_KEYS if k in r}


def test_table2_rows_equal_reference(runs):
    (jrows, _), (trows, _) = runs["j_table2"], runs["t_table2"]
    assert [(r["method"], r["exiguity"]) for r in trows] == \
        list(table2.ROWS)
    assert [_row(r) for r in trows] == [_row(r) for r in jrows]
    for r in trows:
        if r["method"] in ("compressedlut", "reducedlut"):
            assert r["workers"] == 1 and "vs_baseline" in r


def test_every_accuracy_measured_on_the_reference_tables(runs):
    """Each accuracy of Table 2 and Fig. 3 (random fill, CompressedLUT,
    ReducedLUT) runs on tables bit-identical to the reference's, in the
    same order."""
    jt, tt = runs["rec"]["j_tabs"], runs["rec"]["t_tabs"]
    # Table 2: random + compressedlut + 3 reducedlut; Fig. 3: 8 exiguities
    assert len(tt) == len(jt) == 2 * (5 + len(fig3.EXIGUITIES))
    for j, t in zip(jt, tt):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert a.shape == b.shape and np.array_equal(a, b)


def test_random_fill_draws_the_reference_bits(nets):
    """The random row: unobserved entries drawn as the reference draws
    them, observed ones kept."""
    jnet, tnet = nets
    rng = np.random.default_rng(3)
    want = [np.where(o, t, rng.integers(0, 1 << jnet.cfg.beta,
                                        size=t.shape))
            for t, o in zip(jnet.tables, jnet.observed)]
    got = common.random_fill(tnet, seed=3)
    for w, g, t, o in zip(want, got, jnet.tables, jnet.observed):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        assert np.array_equal(g.numpy()[o], t[o]) and (~o).any()


def test_port_net_scores_the_reference_accuracies(nets):
    jnet, tnet = nets
    assert (tnet.test_acc, tnet.train_acc) == (jnet.test_acc, jnet.train_acc)


def test_training_accuracy_unchanged_by_every_row(runs, nets):
    """ReducedLUT and the random fill change only unobserved entries and
    CompressedLUT none: training accuracy is the net's own everywhere,
    and CompressedLUT's test accuracy too."""
    tnet = nets[1]
    rows = runs["t_table2"][0] + runs["t_fig3"]
    assert all(r["train_acc"] == tnet.train_acc for r in rows)
    comp = [r for r in rows if r.get("method") == "compressedlut"]
    assert comp and comp[0]["test_acc"] == tnet.test_acc


def test_timing_identical_with_the_reference_costs(runs):
    (_, jtiming), (_, ttiming) = runs["j_table2"], runs["t_table2"]
    keys = ("model", "n_tables", "workers", "identical")
    assert [{k: t[k] for k in keys} for t in ttiming] == \
        [{k: t[k] for k in keys} for t in jtiming]
    assert ttiming[0]["identical"] is True
    rec = runs["rec"]
    # the timing's two repeats of each path
    assert rec["t_engine"] == rec["j_engine"] and len(rec["t_engine"]) == 2
    assert rec["t_serial"] == rec["j_serial"] and len(rec["t_serial"]) == 2
    assert rec["t_serial"][0] == rec["t_engine"][0]


def test_fig3_points_equal_reference(runs):
    keys = ("model", "exiguity", "pluts", "test_acc", "train_acc",
            "workers", "n_decomposed", "eliminated")
    jrows, trows = runs["j_fig3"], runs["t_fig3"]
    assert [r["exiguity"] for r in trows] == ["baseline",
                                              *fig3.EXIGUITIES]
    assert [{k: r.get(k) for k in keys} for r in trows] == \
        [{k: r.get(k) for k in keys} for r in jrows]


def test_beyond_variants_equal_reference(runs):
    jrows, trows = runs["j_beyond"], runs["t_beyond"]
    assert [(r["model"], r["variant"], r["pluts"]) for r in trows] == \
        [(r["model"], r["variant"], r["pluts"]) for r in jrows]
    assert [r["variant"] for r in trows] == [n for n, _ in beyond.VARIANTS]


@pytest.mark.parametrize("name", ["table2_small", "fig3_tiny_small",
                                  "beyond_tiny_small"])
def test_results_saved_like_the_reference(runs, name):
    import json

    tmp = runs["tmp"]
    got = json.loads((tmp / "port" / f"{name}.json").read_text())
    want = json.loads((tmp / "reference" / f"{name}.json").read_text())
    strip = lambda rows: [{k: v for k, v in r.items() if "seconds" not in k
                           and not k.endswith("_s") and k != "speedup"}
                          for r in rows]
    if name.startswith("table2"):
        for part in ("rows", "timing"):
            assert strip(got[part]) == strip(want[part])
    else:
        assert strip(got) == strip(want)


def test_copied_constants_equal_reference():
    assert table2.ROWS == j_table2.ROWS and table2.MODELS == j_table2.MODELS
    assert fig3.EXIGUITIES == j_fig3.EXIGUITIES
    assert beyond.VARIANTS == j_beyond.VARIANTS
    assert common.M_CANDIDATES == j_common.M_CANDIDATES
    assert common.LB_CANDIDATES == j_common.LB_CANDIDATES
    assert common.SCALED_MODELS.keys() == j_common.SCALED_MODELS.keys()
    for scale, models in j_common.SCALED_MODELS.items():
        assert common.SCALED_MODELS[scale].keys() == models.keys()
        for name, make in models.items():
            assert dataclasses.asdict(common.SCALED_MODELS[scale][name]()) \
                == dataclasses.asdict(make())


class _Stop(Exception):
    pass


@pytest.mark.parametrize("scale", ["small", "paper"])
@pytest.mark.parametrize("model", ["jsc-2l", "jsc-5l", "mnist"])
def test_data_sizes_and_epochs_equal_reference(model, scale, monkeypatch):
    """The reference's ``get_trained`` stopped at its training call: the
    generator, the sizes it asked for and the epochs are the port's."""
    seen = {}

    def maker(name):
        def make(n_train, n_test):
            seen["data"] = (name, n_train, n_test)
            return tuple(np.zeros(1) for _ in range(4))
        return make

    def train(cfg, *data, epochs):
        seen["epochs"] = epochs
        raise _Stop

    monkeypatch.setattr(j_common, "make_jsc", maker("jsc"))
    monkeypatch.setattr(j_common, "make_mnist_like", maker("mnist"))
    monkeypatch.setattr(j_common, "train_lutnn", train)
    monkeypatch.setattr(j_common, "_CACHE", {})
    with pytest.raises(_Stop):
        j_common.get_trained(model, scale)
    make, n_train, n_test = common.DATA[scale][model]
    name = {make_jsc: "jsc", make_mnist_like: "mnist"}[make]
    assert seen == {"data": (name, n_train, n_test),
                    "epochs": common.EPOCHS[scale]}


@pytest.mark.parametrize("model", ["jsc-2l", "mnist"])
def test_data_byte_identical_at_a_small_n(model):
    make = common.DATA["paper"][model][0]
    ref = {make_jsc: j_make_jsc, make_mnist_like: j_make_mnist}[make]
    for a, b in zip(make(120, 40), ref(120, 40)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_settings_from_the_reference_variables(monkeypatch):
    monkeypatch.delenv("REPRO_BENCH_SCALE", raising=False)
    monkeypatch.delenv("REPRO_BENCH_WORKERS", raising=False)
    assert (common.bench_scale(), common.bench_workers()) == \
        (j_common.bench_scale(), j_common.bench_workers()) == ("small", 2)
    monkeypatch.setenv("REPRO_BENCH_SCALE", "paper")
    monkeypatch.setenv("REPRO_BENCH_WORKERS", "0")
    assert (common.bench_scale(), common.bench_workers()) == \
        (j_common.bench_scale(), j_common.bench_workers()) == ("paper", 1)
    assert (common.bench_scale("small"), common.bench_workers(3)) == \
        ("small", 3)


def test_bench_run_on_cpu_at_a_tiny_scale(monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.bench.run --device cpu`` at a registered
    tiny scale: every section runs and prints its CSV rows."""
    tiny = {
        "jsc-2l": lambda: TConfig(**dict(TINY, name="jsc-2l")),
        "jsc-5l": lambda: TConfig(**dict(TINY, name="jsc-5l",
                                         layer_sizes=(8, 6, 5))),
        "mnist": lambda: TConfig(name="mnist", n_inputs=784,
                                 layer_sizes=(12, 10), beta=2, fanin=3,
                                 beta0=2, fanin0=3),
    }
    monkeypatch.setitem(common.SCALED_MODELS, "tiny", tiny)
    monkeypatch.setitem(common.DATA, "tiny", {
        "jsc-2l": (make_jsc, 400, 100), "jsc-5l": (make_jsc, 400, 100),
        "mnist": (make_mnist_like, 200, 50)})
    monkeypatch.setitem(common.EPOCHS, "tiny", 1)
    monkeypatch.setattr(common, "_CACHE", {})
    rows = bench_run.main(["--device", "cpu", "--scale", "tiny",
                           "--workers", "1", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    head, csv = out.split("\nname,us_per_call,derived\n")
    assert "scale=tiny, device=cpu" in head
    lines = csv.strip().splitlines()
    assert len(lines) == len(rows) == 3 * 6 + 1 + 9 + 4
    prefixes = [n.split("_")[0] for n, _, _ in rows]
    assert prefixes.count("table2") == 19 and prefixes.count("fig3") == 9 \
        and prefixes.count("beyond") == 4
    assert any(n.startswith("table2_engine_jsc-2l_w1") for n, _, _ in rows)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "beyond_jsc-2l_tiny.json", "fig3_jsc-2l_tiny.json",
        "table2_tiny.json"]
