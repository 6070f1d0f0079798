"""mix_win_pct: 100 x the window's schedules whose plan is the mix
candidate's (the `winner` of the program's `host.finish` span is "mix"),
over the window's schedules (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    groups = program_spans.by_schedule(trace)
    if groups is None:
        return None
    finishes = [[s for s in spans if s.name == "host.finish"] for spans in groups]
    if not any(finishes):
        return None
    won = sum(any(s.attributes.get("winner") == "mix" for s in spans) for spans in finishes)
    return 100.0 * won / len(groups)
