"""The product CSV's data rows, parsed back: each row is one ``np.savetxt``
line of complex values, ``(re+imj)`` comma-separated (``effex.py:687-696``;
SPECTRUM: one bin a value, CONTINUUM: one value a baseline)."""

from __future__ import annotations

import numpy as np

__all__ = ["parse_row", "read_rows"]


def parse_row(line: bytes) -> np.ndarray:
    """One CSV line (or a block's consecutive lines) -> complex128
    values, in file order."""
    text = line.decode("ascii").strip().replace("\n", ",")
    if not text:
        raise ValueError("empty product row")
    return np.array([complex(v.strip()) for v in text.split(",")],
                    dtype=np.complex128)


def read_rows(path: str, spans) -> list:
    """The rows at byte ``spans`` ``[(start, end), ...]`` of the file at
    ``path``, parsed."""
    out = []
    with open(path, "rb") as fh:
        for start, end in spans:
            fh.seek(start)
            out.append(parse_row(fh.read(end - start)))
    return out
