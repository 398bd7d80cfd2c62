"""Host front end: host time per entry call spent packing the inputs
(the self time of the program's ``fleet.pack`` span, over its
``fleet.call`` spans)."""

from portbench.program_spans import per_call


def read(tr):
    return per_call("fleet.pack", "self_s")
