"""Host front end: host time per control tick spent handing the tick
program to the card (the program's ``fleet.enqueue`` span: the input
copy and the eager enqueue, or a graph replay's copies, replay and carry
clone)."""

from portbench.program_spans import per_tick


def read(tr):
    return per_tick(tr, ("fleet.enqueue",), "host_s")
