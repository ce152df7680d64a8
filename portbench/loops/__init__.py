"""Loop kinds: each file holds ``run(client, traffic, config, clock, rng)``
for one ``"loop"`` of a traffic file.  ``clock`` has ``start`` (the
first request), ``t0`` and ``t1`` (the measured window, from
``time.perf_counter``); a loop sends nothing due at or after ``t1`` and
returns once it has stopped sending."""
