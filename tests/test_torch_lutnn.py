"""The port's LUT-NN toolflow (data, model, training, extraction, don't
cares, ReducedLUT, table inference, Verilog, launchers) against the
reference on the CPU.

Parameters cross with ``bridge.lutnn_params_from_jax``; data and wiring
come from each package's own numpy code and must be byte-identical.  The
network is the reference's ``tiny_net`` configuration
(``tests/test_lutnn.py``), trained once by the reference here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.data import make_jsc as j_make_jsc
from repro.data import make_mnist_like as j_make_mnist
from repro.lutnn import extract_tables as j_extract
from repro.lutnn import mark_observed as j_mark
from repro.lutnn import table_accuracy as j_accuracy
from repro.lutnn import train_lutnn as j_train
from repro.lutnn.extract import network_table_specs as j_specs
from repro.lutnn.extract import observed_calibration_set as j_calib
from repro.lutnn.extract import specs_to_tables as j_regroup
from repro.lutnn.model import LUTNNConfig as JConfig
from repro.lutnn.model import lutnn_forward as j_forward
from repro.lutnn.model import lutnn_init as j_init
from repro.lutnn.model import make_connectivity as j_conn
from repro.lutnn.model import neuron_eval as j_neuron_eval
from repro.lutnn.model import paper_model as j_paper_model
from repro.lutnn.train import _loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import warmup_cosine_schedule as j_schedule
from repro_torch import core as tcore
from repro_torch.bridge import lutnn_params_from_jax
from repro_torch.data import make_jsc, make_mnist_like
from repro_torch.kernels import PlanArrays, lut_reconstruct
from repro_torch.launch import lutnn as lutnn_launcher
from repro_torch.launch import quickstart as quickstart_launcher
from repro_torch.lutnn import (
    device_tables,
    extract_tables,
    mark_observed,
    mark_observed_calibration,
    network_table_specs,
    observed_calibration_set,
    specs_to_tables,
    table_accuracy,
    train_lutnn,
)
from repro_torch.lutnn import train as t_train_mod
from repro_torch.lutnn.extract import enumerate_inputs
from repro_torch.lutnn.model import LUTNNConfig as TConfig
from repro_torch.lutnn.model import lutnn_forward
from repro_torch.lutnn.model import make_connectivity as t_conn
from repro_torch.lutnn.model import neuron_eval, paper_model
from repro_torch.lutnn.train import opt_config, train_step
from repro_torch.optim import adamw_init

TINY = dict(name="tiny", n_inputs=16, layer_sizes=(12, 5), beta=3, fanin=3,
            beta0=3, fanin0=3, seed=0)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny_net():
    """The reference's trained tiny LUT-NN and its tables."""
    jcfg = JConfig(**TINY)
    data = j_make_jsc(3000, 800, seed=1)
    params, conn, metrics = j_train(jcfg, *data, epochs=6)
    return jcfg, TConfig(**TINY), params, conn, j_extract(params, jcfg), \
        data, metrics


@pytest.fixture(scope="module")
def port_net(tiny_net):
    """The same network in the port: parameters carried across, its own
    extracted tables (on the CPU) and wiring."""
    jcfg, tcfg, params, conn, _, data, _ = tiny_net
    model = lutnn_params_from_jax(to_np(params), tcfg, "cpu")
    tables = extract_tables(model, tcfg)
    return model, tables, device_tables(conn, "cpu")


@pytest.mark.parametrize("n_train,n_test,seed", [(300, 100, 0),
                                                 (1000, 37, 5)])
def test_synthetic_data_byte_identical(n_train, n_test, seed):
    for j, t, kw in ((j_make_jsc, make_jsc, {}),
                     (j_make_mnist, make_mnist_like, {"side": 12})):
        for a, b in zip(j(n_train, n_test, seed=seed, **kw),
                        t(n_train, n_test, seed=seed, **kw)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["jsc-2l", "jsc-5l", "mnist", "tiny"])
def test_paper_models_and_wiring_identical(name):
    if name == "tiny":
        jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    else:
        jcfg, tcfg = j_paper_model(name, seed=2), paper_model(name, seed=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for a, b in zip(j_conn(jcfg), t_conn(tcfg)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bridge_copies_parameters_bit_for_bit(tiny_net, port_net):
    _, _, params, *_ = tiny_net
    model = port_net[0]
    for l, layer in enumerate(to_np(params)["layers"]):
        for k, v in layer.items():
            t = getattr(model.layers[l], k).detach().numpy()
            assert t.dtype == v.dtype and t.tobytes() == v.tobytes(), (l, k)
    with pytest.raises(ValueError, match="names differ"):
        lutnn_params_from_jax({"layers": [to_np(params)["layers"][0]]},
                              TConfig(**TINY), "cpu")


@pytest.mark.parametrize("quantized", [True, False])
def test_forward_matches_reference(tiny_net, port_net, quantized):
    """f32 scores allclose (atol 1e-6: the two einsums sum in another
    order) and, quantized, the same output codes."""
    jcfg, tcfg, params, conn, _, (xtr, *_), _ = tiny_net
    x = xtr[:512]
    want = np.asarray(j_forward(params, [jnp.asarray(c) for c in conn], jcfg,
                                jnp.asarray(x), quantized=quantized))
    with torch.no_grad():
        got = lutnn_forward(port_net[0], device_tables(conn, "cpu"), tcfg,
                            torch.as_tensor(x), quantized=quantized).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if quantized:
        levels = (1 << jcfg.beta) - 1
        np.testing.assert_array_equal(np.rint(got * levels),
                                      np.rint(want * levels))


def test_one_training_step_matches_reference(tiny_net):
    """Same initial parameters, same batch: the loss is allclose and the
    parameters after one AdamW step agree to rtol 1e-5 (the einsums and
    the global norm sum in another order)."""
    jcfg, tcfg, _, conn, _, (xtr, ytr, *_), _ = tiny_net
    params = j_init(jcfg)
    total = 66
    j_opt = JAdamWConfig(lr=j_schedule(2e-2, total // 20 + 1, total),
                         weight_decay=1e-4, grad_clip_norm=1.0)
    x, y = xtr[:256], ytr[:256]
    conn_j = [jnp.asarray(c) for c in conn]

    @jax.jit
    def j_step(p, s):
        (loss, acc), g = jax.value_and_grad(
            lambda q: j_loss_fn(q, conn_j, jcfg, jnp.asarray(x),
                                jnp.asarray(y)), has_aux=True)(p)
        p, s, _ = j_adamw_update(g, s, p, j_opt)
        return p, loss, acc

    j_params, j_loss, j_acc = j_step(params, j_adamw_init(params))
    model = lutnn_params_from_jax(to_np(params), tcfg, "cpu")
    state = adamw_init(list(model.parameters()))
    loss, acc = train_step(model, state, device_tables(conn, "cpu"), tcfg,
                           torch.as_tensor(x), torch.as_tensor(y),
                           opt_config(2e-2, total))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    assert float(acc) == pytest.approx(float(j_acc), abs=1e-7)
    assert state["count"] == 1
    for l, layer in enumerate(to_np(j_params)["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(
                getattr(model.layers[l], k).detach().numpy(), v, rtol=1e-5,
                atol=1e-7, err_msg=f"layers.{l}.{k}")


def test_training_from_reference_init_tracks_reference(tiny_net,
                                                       monkeypatch):
    """Six epochs of the port's ``train_lutnn`` from the reference's
    initial parameters land on the reference's metrics: same batches,
    same schedule, same optimizer association.  (Within 0.01: a score
    that rounds to the other side of a quantizer bin moves a sample.)"""
    jcfg, tcfg, _, _, _, data, j_metrics = tiny_net
    init = to_np(j_init(jcfg))
    monkeypatch.setattr(t_train_mod, "lutnn_init",
                        lambda cfg, dev: lutnn_params_from_jax(init, cfg,
                                                               dev))
    _, _, metrics = train_lutnn(tcfg, *data, epochs=6, device="cpu")
    for k in ("train_acc", "test_acc"):
        assert metrics[k] == pytest.approx(j_metrics[k], abs=0.01), k
    assert metrics["loss"] == pytest.approx(j_metrics["loss"], rel=1e-3)


def test_port_training_learns():
    """The port's own ``train_lutnn`` (its own initialisation) learns.
    Shown on the paper's jsc-2l model: the tiny configuration stays below
    0.5 from some initial draws in both packages (the reference from
    seeds 1 and 2, the port from seed 0)."""
    data = make_jsc(3000, 800, seed=1)
    _, _, metrics = train_lutnn(paper_model("jsc-2l"), *data, epochs=6,
                                device="cpu")
    assert metrics["train_acc"] > 0.5
    assert metrics["test_acc"] > 0.5


def test_extracted_tables_match_reference(tiny_net, port_net):
    """Truth tables from carried parameters equal the reference's.  An
    entry may flip only where the activation times the level count lies
    within 2 ulp of a half-integer (sigmoid and einsum round differently
    in the two packages), and on at most 1e-4 of the entries."""
    jcfg, tcfg, params, _, j_tables, *_ = tiny_net
    model, t_tables, _ = port_net
    levels = (1 << jcfg.beta) - 1
    flips = total = 0
    for l, (a, b) in enumerate(zip(j_tables, t_tables)):
        b = b.numpy()
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
        total += a.size
        diff = np.argwhere(a != b)
        flips += len(diff)
        if len(diff):
            deq = enumerate_inputs(tcfg, l)
            n = a.shape[0]
            inputs = np.broadcast_to(deq[:, None, :],
                                     (deq.shape[0], n, deq.shape[1]))
            ref = np.asarray(jax.jit(j_neuron_eval)(
                params["layers"][l], jnp.asarray(inputs))) * np.float32(
                    levels)
            with torch.no_grad():
                port = neuron_eval(model.layers[l], torch.as_tensor(
                    np.ascontiguousarray(inputs))).numpy() * np.float32(
                        levels)
            for i, addr in diff:
                for v in (ref[addr, i], port[addr, i]):
                    half = np.floor(v) + np.float32(0.5)
                    assert abs(v - half) <= 2 * np.spacing(np.float32(v))
    assert flips <= 1e-4 * total


def test_numpy_helpers_match_reference():
    from repro.lutnn import inference as ji
    from repro_torch.lutnn import inference as ti

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 997),
                        (np.arange(16) + 0.5) / 15]).astype(np.float32)
    for bits in (2, 3, 4, 7):
        want = ji.quantize_input(x, bits)
        np.testing.assert_array_equal(ti.quantize_input(x, bits), want)
        np.testing.assert_array_equal(
            ti.quantize_codes(x, bits, "cpu").numpy(), want)
    codes = rng.integers(0, 8, (40, 3))
    addr = ji.pack_codes(codes, 3)
    np.testing.assert_array_equal(ti.pack_codes(codes, 3), addr)
    np.testing.assert_array_equal(ti.unpack_address(addr, 3, 3),
                                  ji.unpack_address(addr, 3, 3))


def test_observed_masks_specs_and_calibration_match(tiny_net, port_net):
    jcfg, tcfg, _, conn, j_tables, (xtr, *_), _ = tiny_net
    _, _, conn_d = port_net
    t_tables = device_tables(j_tables, "cpu")
    j_obs = j_mark(j_tables, conn, jcfg, xtr)
    t_obs = mark_observed(t_tables, conn_d, tcfg, xtr)
    for a, b in zip(j_obs, t_obs):
        assert b.dtype == torch.bool
        np.testing.assert_array_equal(a, b.numpy())
        assert 0.0 < a.mean() < 1.0
    jc, tc = j_calib(j_obs, jcfg), observed_calibration_set(t_obs, tcfg)
    tc2 = mark_observed_calibration(t_tables, conn_d, tcfg, xtr)
    for c in (tc, tc2):
        assert jc.masks.keys() == c.masks.keys()
        for k in jc.masks:
            np.testing.assert_array_equal(jc.masks[k], c.masks[k])
        assert (jc.w_in, jc.meta) == (c.w_in, c.meta)
    for observed in (None, (j_obs, t_obs), (jc, tc)):
        js = j_specs(j_tables, observed and observed[0], jcfg)
        ts = network_table_specs(t_tables, observed and observed[1], tcfg)
        assert len(js) == len(ts) == tcfg.n_luts
        for a, b in zip(js, ts):
            assert (a.name, a.w_in, a.w_out) == (b.name, b.w_in, b.w_out)
            assert a.values.tobytes() == b.values.tobytes()
            np.testing.assert_array_equal(a.care_mask(), b.care_mask())
    values = [s.values for s in js]
    for a, b, c in zip(j_regroup(values, jcfg), specs_to_tables(values, tcfg),
                       specs_to_tables([torch.as_tensor(v) for v in values],
                                       tcfg)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())


def test_table_accuracy_matches_reference_including_ties(tiny_net, port_net):
    """Output codes are 3-bit over 5 classes, so argmax ties are common;
    both packages break them to the first index.  A last layer that
    outputs one constant code ties every class on every sample."""
    jcfg, tcfg, _, conn, j_tables, (xtr, ytr, xte, yte), _ = tiny_net
    conn_d = port_net[2]
    tied = [j_tables[0], np.full_like(j_tables[1], 3)]
    coarse = [j_tables[0], j_tables[1] >> 1]          # many partial ties
    for tabs in (j_tables, tied, coarse):
        for x, y in ((xtr, ytr), (xte, yte)):
            assert table_accuracy(device_tables(tabs, "cpu"), conn_d, tcfg,
                                  x, y) == j_accuracy(tabs, conn, jcfg, x, y)
    assert j_accuracy(tied, conn, jcfg, xte, yte) == float(np.mean(yte == 0))


def test_compression_preserves_training_accuracy_exactly(tiny_net,
                                                         port_net):
    """Paper SS4.1 on the port: ReducedLUT plans, reconstructed through
    ``lut_reconstruct``, leave training accuracy unchanged."""
    jcfg, tcfg, _, _, _, (xtr, ytr, *_), _ = tiny_net
    _, tables, conn_d = port_net
    obs = mark_observed(tables, conn_d, tcfg, xtr)
    specs = network_table_specs(tables, obs, tcfg)
    ccfg = tcore.CompressConfig(exiguity=100, m_candidates=(16, 64),
                                lb_candidates=(0, 1))
    plans = tcore.compress_network(specs, ccfg)
    for spec, plan in zip(specs, plans):
        assert tcore.verify_care_exact(spec, plan)
    tab_r = specs_to_tables(
        [lut_reconstruct(torch.arange(1 << p.w_in, dtype=torch.int32),
                         PlanArrays.from_plan(p, device="cpu"))
         for p in plans], tcfg)
    assert table_accuracy(tables, conn_d, tcfg, xtr, ytr) == \
        table_accuracy(tab_r, conn_d, tcfg, xtr, ytr)


def _verilog_plans(pkg):
    specs = [pkg.TableSpec.random(7, 5, 0.5, seed=1, smooth=True, name="a"),
             pkg.TableSpec.random(8, 6, 0.3, seed=2, smooth=True, name="b"),
             pkg.TableSpec.random(6, 4, 0.0, seed=3, name="c"),
             pkg.TableSpec.random(9, 7, 0.6, seed=4, smooth=True, name="d")]
    cfg = pkg.CompressConfig(exiguity=250, m_candidates=(8, 16),
                             lb_candidates=(0, 1, 2))
    spec = pkg.TableSpec.random(6, 6, 0.3, seed=5, smooth=True)
    d = pkg.make_decomposition(spec.values >> 2, spec.care_mask(), 8)
    lb = pkg.pipeline.pack_decomposition(
        d, w_in=6, w_hb=4, w_lb=2, lb_values=spec.values & 3, name="lb")
    return [pkg.compress_table(s, cfg) for s in specs] + [
        pkg.PlainPlan(specs[2].values, 6, 4, name="p"), lb]


def test_verilog_byte_identical():
    jp, tp = _verilog_plans(jcore), _verilog_plans(tcore)
    kinds = {p.kind for p in tp}
    assert kinds == {"decomposed", "plain"}
    assert any(p.kind == "decomposed" and p.w_lb > 0 for p in tp)
    for a, b in zip(jp, tp):
        assert jcore.plan_to_verilog(a) == tcore.plan_to_verilog(b)
    assert jcore.network_to_verilog(jp) == tcore.network_to_verilog(tp)


def test_network_verilog_byte_identical(tiny_net):
    """The tiny network's ReducedLUT plans, emitted by both packages."""
    jcfg, tcfg, _, conn, j_tables, (xtr, *_), _ = tiny_net
    obs = j_mark(j_tables, conn, jcfg, xtr)
    kw = dict(exiguity=250, m_candidates=(16,), lb_candidates=(0, 1))
    jp = jcore.compress_network(j_specs(j_tables, obs, jcfg),
                                jcore.CompressConfig(**kw))
    tp = tcore.compress_network(network_table_specs(j_tables, obs, tcfg),
                                tcore.CompressConfig(**kw))
    assert jcore.network_to_verilog(jp) == tcore.network_to_verilog(tp)


def test_lutnn_launcher_runs_on_cpu(tmp_path):
    path = tmp_path / "net.v"
    out = lutnn_launcher.main(["--device", "cpu", "--n-train", "600",
                               "--n-test", "200", "--epochs", "2",
                               "--workers", "1", "--verilog-out", str(path)])
    assert out["device"] == "cpu"
    acc = out["accuracy"]
    assert acc["train_before"] == acc["train_after"]
    assert out["plans"]["decomposed"] + out["plans"]["plain"] == 37
    assert out["pluts"]["reducedlut"] <= out["pluts"]["compressedlut"] \
        <= out["pluts"]["baseline"]
    assert path.read_text().count("\n") == out["verilog_lines"]
    assert set(out["seconds"]) == {"train", "extract", "dont_cares",
                                   "compress", "reconstruct", "accuracy",
                                   "verilog"}


def test_quickstart_launcher_runs_on_cpu():
    out = quickstart_launcher.main(["--device", "cpu"])
    assert out["care_exact"]
    assert out["reducedlut_250"] <= out["compressedlut"] <= out["baseline"]
