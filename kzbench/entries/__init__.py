"""Entries: how a traffic mix drives the program, one module each, named by
the traffic's ``entry``. Each provides ``setup(config, traffic, seed,
device) -> job``; ``window(job, seconds, trace)``, which sets
``job.window_t0`` at the first timed call (and ``job.records`` when
traced); ``calls``, ``end_to_end`` and ``notes`` of a job; ``check(job,
limits) -> (readings, failed)``; and, for ``control.py``, ``outputs(job)``,
``expected(job, precision)`` and ``compare(got, want)``."""
