"""Truth-table extraction and don't-care identification (paper SS4.1).

Counterpart of the reference's ``lutnn/extract.py``.  Extraction
enumerates every input combination of every neuron and evaluates the
trained functional form on the model's device; don't cares are the
addresses never visited when the training set runs through the table
network (:func:`mark_observed`, on the tables' device).

Observed masks pack into the port's :class:`~repro_torch.calib.
CalibrationSet` (``L{layer}/n{i}`` keys), the same form the serving
stack's calibration uses, and :func:`network_table_specs` accepts either
form.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.calib import CalibrationSet, site_key
from repro_torch.core import TableSpec

from .inference import quantize_codes, table_forward, unpack_address
from .model import LUTNN, LUTNNConfig, neuron_eval


def enumerate_inputs(cfg: LUTNNConfig, layer: int) -> np.ndarray:
    """The dequantized parent activations of every address of a layer's
    tables: (2^w_in, F) float32, parent 0 the most significant."""
    bits = cfg.layer_beta_in(layer)
    fanin = cfg.layer_fanin(layer)
    addrs = np.arange(1 << (bits * fanin), dtype=np.int64)
    codes = unpack_address(addrs, bits, fanin)
    return codes.astype(np.float32) / ((1 << bits) - 1)


@torch.no_grad()
def extract_tables(model: LUTNN, cfg: LUTNNConfig) -> list[torch.Tensor]:
    """Enumerate each layer's truth tables on the model's device: list of
    (n_l, 2^w_in_l) int32 output codes."""
    tables = []
    for l, layer in enumerate(model.layers):
        deq = torch.as_tensor(enumerate_inputs(cfg, l),
                              device=layer.w1.device)
        n = layer.b2.shape[0]
        inputs = deq[:, None, :].expand(deq.shape[0], n, deq.shape[1])
        act = neuron_eval(layer, inputs)                    # (2^w_in, n)
        codes = torch.round(act * ((1 << cfg.beta) - 1)).to(torch.int32)
        tables.append(codes.T.contiguous())                 # (n, 2^w_in)
    return tables


def mark_observed(
    tables: list[torch.Tensor],
    conn: list[torch.Tensor],
    cfg: LUTNNConfig,
    x_train: np.ndarray,
) -> list[torch.Tensor]:
    """Per-layer bool masks (n_l, 2^w_in_l) on the tables' device: True =
    observed in training."""
    dev = tables[0].device
    observers = [torch.zeros(t.shape, dtype=torch.bool, device=dev)
                 for t in tables]
    table_forward(tables, conn, cfg, quantize_codes(x_train, cfg.beta0, dev),
                  observers=observers)
    return observers


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def observed_calibration_set(
    observed: list, cfg: LUTNNConfig
) -> CalibrationSet:
    """Pack per-layer observed masks into the shared calibration-artifact
    form: one ``L{layer}/n{i}`` mask per neuron.  ``w_in`` is left unset —
    LUT-NN layers have heterogeneous input widths, and the masks carry
    their own lengths."""
    masks = {
        site_key(f"n{i}", layer=l): obs[i]
        for l, obs in enumerate(map(_host, observed))
        for i in range(obs.shape[0])
    }
    return CalibrationSet(masks=masks, w_in=None,
                          meta={"source": "lutnn", "name": cfg.name,
                                "layer_sizes": list(cfg.layer_sizes)})


def mark_observed_calibration(
    tables: list[torch.Tensor],
    conn: list[torch.Tensor],
    cfg: LUTNNConfig,
    x_train: np.ndarray,
) -> CalibrationSet:
    """:func:`mark_observed` + :func:`observed_calibration_set` in one
    step — the LUT-NN analogue of ``repro_torch.calib.
    capture_calibration``."""
    return observed_calibration_set(
        mark_observed(tables, conn, cfg, x_train), cfg)


def network_table_specs(
    tables: list,
    observed: list | CalibrationSet | None,
    cfg: LUTNNConfig,
) -> list[TableSpec]:
    """Flatten the network into per-neuron :class:`TableSpec`s (host
    numpy; tables and masks may be tensors on any device).

    ``observed`` may be the raw per-layer mask list from
    :func:`mark_observed` or a :class:`~repro_torch.calib.CalibrationSet`;
    ``None`` produces all-care specs (CompressedLUT baseline).
    """
    calib = observed if isinstance(observed, CalibrationSet) else None
    if observed is not None and calib is None:
        observed = [_host(o) for o in observed]
    specs = []
    for l, table in enumerate(map(_host, tables)):
        w_in = cfg.layer_w_in(l)
        for i in range(table.shape[0]):
            if observed is None:
                care = None
            elif calib is not None:
                care = calib.mask_for(f"n{i}", layer=l)
                if care is None:
                    raise ValueError(
                        f"network_table_specs: calibration has no mask "
                        f"for neuron L{l}/n{i}")
            else:
                care = observed[l][i]
            specs.append(TableSpec(
                values=table[i], w_in=w_in, w_out=cfg.beta,
                care=care, name=f"{cfg.name}_l{l}_n{i}",
            ))
    return specs


def specs_to_tables(specs_values: list, cfg: LUTNNConfig) -> list:
    """Regroup flat per-neuron value arrays back into per-layer tables
    (numpy arrays stack with numpy, tensors with torch)."""
    stack = torch.stack if torch.is_tensor(specs_values[0]) else np.stack
    tables = []
    k = 0
    for n in cfg.layer_sizes:
        tables.append(stack([specs_values[k + i] for i in range(n)]))
        k += n
    return tables
