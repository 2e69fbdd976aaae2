"""The kernels' abstract route: what a dry run traces in place of a launch.

A dry run (:mod:`repro_torch.launch.dryrun`) runs the port's own step on
tensors without data, on the ``meta`` device (or fake tensors inside a
``FakeTensorMode``).  They have shapes, strides, dtypes and devices but
no memory, so a wrapper cannot hand their pointers to a kernel.  Inside
:func:`abstract` every wrapper of :mod:`.ops` validates its operands as it
does before a launch, tells the active cost counter
(:mod:`repro_torch.roofline.costs`) what the kernel reads, writes and
computes, and returns an empty result of the kernel's shape, dtype and
device.  Nothing launches, so the wrappers' own launch counts stay as they
were.  A shape a kernel refuses (K8's head size, K3's tile plan) still
raises.  Inside :func:`abstract` a ``meta`` tensor counts as one on the
card.

Outside it nothing changes: a tensor on the card goes to the kernel, one
on the CPU to the plain version, and any other raises; so does a fake
tensor on the card (:func:`check_data`), whose pointer is no address.
"""
from __future__ import annotations

import contextlib
import sys

import torch

_DEPTH = [0]

# streaming multiprocessors of an H100 SXM5: the card the abstract route
# plans for where the trace runs on the meta device
H100_SMS = 132


@contextlib.contextmanager
def abstract():
    """Trace the kernels instead of launching them (module docstring)."""
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def is_abstract() -> bool:
    return _DEPTH[0] > 0


def on_card(device: torch.device) -> bool:
    """True for the card, and for its ``meta`` stand-in inside
    :func:`abstract`."""
    return device.type == "cuda" or (device.type == "meta" and is_abstract())


def no_data(t: torch.Tensor) -> bool:
    """True for a tensor without data: a fake one (``FakeTensorMode``) or
    one on the ``meta`` device."""
    if t.device.type == "meta":
        return True
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and isinstance(t, fake.FakeTensor)


def check_data(name: str, *tensors) -> None:
    """Refuse a launch on tensors without data outside :func:`abstract`:
    a fake tensor's pointer is no address, and the kernel would read
    through it."""
    if not is_abstract() and any(t is not None and no_data(t)
                                 for t in tensors):
        raise ValueError(
            f"{name}: a fake or meta tensor has no data to launch the "
            f"kernel on; trace it inside repro_torch.kernels.ops.abstract()")


def traced_sm_count(device: torch.device, count) -> int:
    """The SM count a plan is made for: the card's (``count(device)``), or
    an H100's where the trace runs on the ``meta`` device."""
    return H100_SMS if device.type == "meta" else count(device)
