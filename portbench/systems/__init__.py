"""Systems under test, one module per kind, found by the configuration
file's ``system`` key: ``portbench/systems/<system>.py``.

A system module has a class ``System(cfg, traffic, scene, seed, device)``
with:

- ``call(inputs)``: the timed entry point, on one call's inputs (what
  the scene's ``inputs()`` gave); returns the outputs, on the host;
- ``record(inputs, out)``: keep, outside the timed span, what the output
  check needs;
- ``solves(out)``: the units of work the call completed (``solves_per_s``);
- ``counts(out)``: per-call counters for the traced run's readers
  (``calls`` is counted by the harness);
- ``work``: a dict of static sizes for the readers (the roofline's);
- ``release()``: free the program's state before the check;
- ``check(first_call, control=False)``: the output check over the calls
  recorded from index ``first_call`` on; the numbers compared (and
  ``judged_rows``), with ``control`` also the control's numbers.

A new kind of system (another entry point, another drive, the mapper)
is a new module here and its plain reference under ``reference/``; its
scenes are modules under ``scenes/``.
"""
