"""Idle ms of the card a traced query while the host ran the program's
own Python inside a probe strand (gaps whose innermost host event is an
``hj.probe`` span)."""

from ..program_trace import glue_idle_ms


def read(run):
    return glue_idle_ms(run, "hj.probe")
