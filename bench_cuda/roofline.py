"""The work of an operation, counted from its shapes alone: each input
byte read once and each output byte written once, whatever the kernel
that does it reads again.  A later kernel that does the same operation
reads the same work.  Sizes come from a configuration's ``rows``."""

from __future__ import annotations

KEY_BYTES = 4   #: a u32 key
ROW_BYTES = 4   #: an int32 row id or looked-up word


def sort_bytes(keys: int) -> int:
    """Sort ``keys`` u32 keys into (sorted key, original row): read the
    keys, write the keys and their rows."""
    return keys * (KEY_BYTES + KEY_BYTES + ROW_BYTES)


def lookup_bytes(table: int, keys: int) -> int:
    """Look ``keys`` keys up in a ``table``-word table: read the table and
    the keys, write one word a key."""
    return table * ROW_BYTES + keys * KEY_BYTES + keys * ROW_BYTES


#: operation name in a traffic mix's ``ops`` -> (work function, the
#: ``rows`` of the configuration its arguments name)
WORK = {"probe_sort": (sort_bytes, ("keys",)),
        "lookup": (lookup_bytes, ("table", "keys"))}


def op_bytes(op: str, spec: dict, rows: dict) -> int:
    """Bytes of operation ``op`` whose traffic entry ``spec`` names the
    relations of its arguments."""
    fn, args = WORK[op]
    return fn(*(int(rows[spec[a]]) for a in args))
