"""Idle ms of the card a traced query while the host ran the program's
own Python inside a build (gaps whose innermost host event is an
``hj.build`` span)."""

from ..program_trace import glue_idle_ms


def read(run):
    return glue_idle_ms(run, "hj.build")
