"""Transfer: host time per entry call from the enqueued program to the
outputs as numpy on the host (the program's ``fleet.fetch`` span: the
wait for the card, the output copy and the output dict)."""

from portbench.program_spans import per_call


def read(tr):
    return per_call("fleet.fetch", "host_s")
