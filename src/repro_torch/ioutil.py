"""Checksummed ``.npz`` artifact I/O shared by the plan/calib stores (own
copy of the reference's ``ioutil.py``, numpy only: the two packages write
and read the same files).

Every persisted artifact in the repo (tuned plans, calibration sets) is a
compressed ``.npz`` with a JSON header riding in a ``__header__`` uint8
entry.  This module centralizes the write/read discipline those stores
share:

* **atomic writes** — the payload lands in ``<path>.tmp`` and is renamed
  into place, so a crashed save never leaves a half-written artifact at
  the published path;
* **content checksums** — a CRC32 over every payload array (name, dtype,
  shape, raw bytes) is stored in the header at save time and re-verified
  on load, so bit-flips that survive the zip layer's own per-member CRC
  are still caught before garbage deserializes into serving tables;
* **clear failure modes** — truncated files, non-zip bytes, missing
  headers and checksum mismatches all raise :class:`ArtifactError`
  naming the file and the artifact kind, instead of surfacing a raw
  ``zipfile``/``zlib`` traceback from deep inside ``np.load``.

Artifacts written before checksums existed (no ``"checksum"`` header
key) still load — verification only runs when the save recorded one.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

HEADER_KEY = "__header__"


class ArtifactError(ValueError):
    """A persisted artifact is unreadable, corrupt, or the wrong kind."""


def payload_checksum(payload: dict) -> int:
    """CRC32 over the payload arrays in name order — covers each entry's
    name, dtype, shape and raw bytes, so reordered/retyped/resized
    entries fail just like flipped bits."""
    crc = 0
    for key in sorted(payload):
        if key == HEADER_KEY:
            continue
        arr = np.ascontiguousarray(payload[key])
        crc = zlib.crc32(
            f"{key}|{arr.dtype.str}|{arr.shape}".encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc


def save_checked_npz(path: str, header: dict, payload: dict,
                     kind: str = "artifact") -> str:
    """Atomically write ``payload`` + JSON ``header`` (checksum added) to
    ``path`` (``.npz`` appended if missing).  Returns the final path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    header = dict(header, checksum=payload_checksum(payload))
    full = {
        HEADER_KEY: np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8),
    }
    full.update(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **full)
    os.replace(tmp, path)
    return path


def load_checked_npz(path: str, kind: str = "artifact") -> tuple[dict, dict]:
    """Read ``(header, arrays)`` back, eagerly and verified.

    Every array is materialized inside the ``np.load`` context (the zip
    member CRCs fire here for torn files) and the header checksum, when
    present, is re-verified over the loaded payload.  Any failure raises
    :class:`ArtifactError` naming ``path`` and ``kind``.
    """
    try:
        with np.load(path) as data:
            if HEADER_KEY not in data:
                raise ArtifactError(
                    f"{path}: not a {kind} artifact (missing header)")
            header = json.loads(bytes(data[HEADER_KEY]).decode("utf-8"))
            arrays = {k: np.asarray(data[k]) for k in data.files
                      if k != HEADER_KEY}
    except ArtifactError:
        raise
    except Exception as e:  # BadZipFile / zlib.error / OSError / EOFError
        raise ArtifactError(
            f"{path}: cannot read {kind} artifact "
            f"({type(e).__name__}: {e}) — the file is corrupt, truncated, "
            f"or not an .npz; re-export it") from e
    want = header.get("checksum")
    if want is not None and payload_checksum(arrays) != want:
        raise ArtifactError(
            f"{path}: {kind} artifact failed its content checksum — the "
            f"payload does not match what was written at save time "
            f"(corrupt or tampered file); re-export the artifact")
    return header, arrays
