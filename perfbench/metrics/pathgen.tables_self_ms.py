"""pathgen.tables_self_ms: the ``pathgen.tables`` span's self time a
pricing, in ms: the host's build and upload of a new seed's Sobol direction
tables (the span holds no other span, so its time is its self time); the
median over the program-span phase's pricings without the profiler, each on
a new seed (``perfbench/spans.py`` (b)). Nothing to read where the program
opens no such span."""

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    return prog["span_ms"].get("pathgen.tables") if prog else None
