"""Bit-packed plan-component slabs: sub-int32 table codes in int32 words.

Own copy of the reference's ``kernels/packing.py``: the host packing is
numpy (byte-identical words), the in-kernel unpack has a torch form
(:func:`unpack_take`) used by the kernels' plain versions.

The engine's plan components are small non-negative (or small-magnitude)
integers — ``t_ust`` values are at most ``w_out`` bits, ``t_idx`` indexes a
handful of subtables, ``t_rsh``/``t_lb`` are tiny shift amounts / low-bit
codes, ``t_bias`` is a small signed correction — yet the device slabs store
every element as a full int32 lane (`kernels/ops.py` pads each component to
int32).  That 2–16x of dead weight is exactly the footprint the paper's
compression wins back, so the serving hot path packs each component into
the narrowest sufficient width: codes are biased by the component minimum
(so signed biases pack losslessly), ``per_word = 32 // width`` codes share
one int32 word, and the kernels unpack with one extra take + shift + mask
(:func:`unpack_take`).

Packing is **lossless by construction** (the reference round-trip tests
it for widths 2–16; tests/test_torch_slabs.py holds the port's words
byte-equal to the reference's and its :func:`unpack_take` equal to the
reference's ``unpack_array``); the gather backend keeps consuming the
unpacked int32 arrays.
Widths above :data:`MAX_PACK_WIDTH` fall back to raw int32 storage
(``width=32``, one code per word) so pathological tables never lose bits.
"""
from __future__ import annotations

import numpy as np

# Canonical component order of a decomposed plan's device arrays.  The
# packed meta tables of the multi-site kernel index components by this
# order, so it is part of the slab format.
COMPONENTS = ("t_ust", "t_idx", "t_rsh", "t_bias", "t_lb")

# Widest width still packed (>= 2 codes per int32 word); anything wider
# stores raw.  Plan components are bounded by w_out <= 16 bits in
# practice, so the fallback is a safety valve, not a real path.
MAX_PACK_WIDTH = 16


def needed_width(a: np.ndarray) -> tuple[int, int]:
    """(width, offset) of the narrowest biased encoding of ``a``.

    ``offset`` is the component minimum (biasing makes signed biases
    non-negative); ``width`` the bit count of the biased maximum, at
    least 1 so empty/constant components stay representable.
    """
    a = np.asarray(a)
    if a.size == 0:
        return 1, 0
    offset = int(a.min())
    span = int(a.max()) - offset
    return max(1, int(span).bit_length()), offset


def pack_array(a: np.ndarray, width: int | None = None,
               offset: int | None = None) -> tuple[np.ndarray, dict]:
    """Pack int array ``a`` (1-D or 2-D, packed along the last axis) into
    int32 words.  Returns ``(words, meta)`` with ``meta`` the python-int
    unpack parameters ``{"width", "offset", "per_word", "n"}``.
    """
    a = np.asarray(a, np.int64)
    if width is None or offset is None:
        width, offset = needed_width(a)
    if width > MAX_PACK_WIDTH:
        width, offset = 32, 0
    per_word = 32 // width
    n = a.shape[-1]
    meta = {"width": width, "offset": offset, "per_word": per_word, "n": n}
    if width == 32:
        return a.astype(np.int32), meta
    codes = (a - offset).astype(np.uint64)
    if codes.size and int(codes.max()) >> width:
        raise ValueError(
            f"pack_array: value {int(a.max())} does not fit width {width} "
            f"at offset {offset}")
    n_words = -(-n // per_word)
    pad = n_words * per_word - n
    if pad:
        pad_shape = a.shape[:-1] + (pad,)
        codes = np.concatenate(
            [codes, np.zeros(pad_shape, np.uint64)], axis=-1)
    codes = codes.reshape(a.shape[:-1] + (n_words, per_word))
    shifts = (np.arange(per_word, dtype=np.uint64) * width)
    words = (codes << shifts).sum(axis=-1, dtype=np.uint64)
    return words.astype(np.uint32).view(np.int32), meta


def unpack_take(words, idx, *, width: int, offset: int, per_word: int):
    """Gather element ``idx`` out of a packed word row (torch tensors) —
    the plain form of the kernels' in-register unpack.

    ``(word >> shift) & mask`` is correct under arithmetic right shift:
    the mask discards any sign-extension bits, so the extracted field
    equals the stored biased code regardless of the word's sign.  Width 32
    is the raw path (one code per word, no shift).
    """
    idx = idx.long()
    if width == 32:
        return words[idx]
    w = words[idx // per_word]
    sh = ((idx % per_word) * width).to(words.dtype)
    return ((w >> sh) & ((1 << width) - 1)) + offset


def pack_component_dict(arrays: dict) -> tuple[dict, dict]:
    """Pack every plan component of an ``arrays`` dict (values indexable
    as numpy; 1-D per-plan or 2-D stacked ``(L, n)``).  Returns
    ``(packed_arrays, pack_meta)`` keyed by component name."""
    packed, meta = {}, {}
    for c, a in arrays.items():
        packed[c], meta[c] = pack_array(np.asarray(a))
    return packed, meta
