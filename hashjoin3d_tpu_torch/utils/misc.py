"""Small formatting/math helpers mirroring the reference's util layer.

Port (a copy: the module is plain Python) of ``hashjoin3d_tpu/utils/misc.py``.

Equivalents of ``util/output_helpers.hh`` (indent), ``util/math.hh``
(factorial/binomial/number_of_digits/is_power_of),
``util/chrono_helpers.hh`` (SI-prefixed duration strings),
``util/string_helpers.hh`` (trim/case), and ``util/debugging_helpers.hh``
(``type_name`` pretty-printer -- here over arrays, tensors and containers
instead of C++ template types).
"""

from __future__ import annotations

import math


def indent(level: int, width: int = 2) -> str:
    """Indentation prefix (``util/output_helpers.hh:23-50``)."""
    return " " * (level * width)


def factorial(n: int) -> int:
    return math.factorial(n)


def binomial(n: int, k: int) -> int:
    return math.comb(n, k)


def number_of_digits(x: int, base: int = 10) -> int:
    """Digits of x in the given base (``util/math.hh``)."""
    if x == 0:
        return 1
    n = 0
    x = abs(x)
    while x:
        x //= base
        n += 1
    return n


def is_power_of(x: int, base: int) -> bool:
    if x < 1:
        return False
    while x % base == 0:
        x //= base
    return x == 1


# -- string helpers (util/string_helpers.hh:8-36) -----------------------------

def ltrim(s: str, chars: str = " \t\n\r") -> str:
    return s.lstrip(chars)


def rtrim(s: str, chars: str = " \t\n\r") -> str:
    return s.rstrip(chars)


def trim(s: str, chars: str = " \t\n\r") -> str:
    return s.strip(chars)


def to_lower(s: str) -> str:
    return s.lower()


def to_upper(s: str) -> str:
    return s.upper()


# -- debugging helpers (util/debugging_helpers.hh:8-38) -----------------------

def type_name(x) -> str:
    """Compact type descriptor: ``uint32[1024]`` for arrays and tensors,
    containers nested.

    The analogue of the reference's demangled ``type_name<T>()`` used to print
    plan/tuple types (``main_experiment1.cc:485-490``): here the interesting
    "types" are array and tensor shapes/dtypes and container structure.
    """
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        dims = ",".join(str(d) for d in x.shape)
        return f"{x.dtype}[{dims}]"
    if isinstance(x, dict):
        inner = ", ".join(f"{k}: {type_name(v)}" for k, v in x.items())
        return "{" + inner + "}"
    if isinstance(x, (list, tuple)):
        inner = ", ".join(type_name(v) for v in x)
        return ("[%s]" if isinstance(x, list) else "(%s)") % inner
    return type(x).__name__


_SI = [(1.0, "s"), (1e-3, "ms"), (1e-6, "us"), (1e-9, "ns")]


def duration_str(seconds: float, sep: str = " ") -> str:
    """Human duration like the reference's ``to_string(duration)``: "123 ms"."""
    for scale, unit in _SI:
        if abs(seconds) >= scale or unit == "ns":
            v = seconds / scale
            if abs(v) >= 100:
                return f"{v:.0f}{sep}{unit}"
            return f"{v:.3g}{sep}{unit}"
    return f"{seconds}{sep}s"
