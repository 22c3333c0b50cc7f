"""Measurement CSV emitter, byte-compatible with the reference's CSVWriter.

Port of ``hashjoin3d_tpu/utils/csv_writer.py`` (reference
``util/csv_writer.{hh,cc}``): ';'-separated fields, chainable, floats at six
significant digits like a C++ ostream, bools as 0/1.
"""

from __future__ import annotations

import sys
from pathlib import Path


def format_field(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


class CSVWriter:
    """``target``: a path (its directory must exist), a file-like object, or
    None for stdout."""

    SEP = ";"

    def __init__(self, target=None):
        self._line_started = False
        self._owns = False
        if target is None:
            self._out = sys.stdout
        elif isinstance(target, (str, Path)):
            p = Path(target)
            if not p.parent.exists():
                raise FileNotFoundError(f"directory {p.parent} does not exist")
            self._out = open(p, "w")
            self._owns = True
        else:
            self._out = target

    def write_fields(self, *vs) -> "CSVWriter":
        for v in vs:
            if self._line_started:
                self._out.write(self.SEP)
            self._out.write(format_field(v))
            self._line_started = True
        return self

    def newline(self) -> "CSVWriter":
        self._out.write("\n")
        self._line_started = False
        self._out.flush()
        return self

    def close(self) -> None:
        if self._owns:
            self._out.close()
