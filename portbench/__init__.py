"""The benchmark of ``band_tpu_torch`` on NVIDIA cards.

``run.py`` runs one cell of ``BENCHMARK.json`` (at the checkout's root)
and prints its result line.  A cell is a configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<name>.json``,
whose ``loop`` names a file of ``loops/``); each metric has a reader in
``metrics/``.  ``reference/`` is the plain reference that decides
``correct``, ``work.py`` the operations and bytes of each graph op,
``trace.py`` the reduction of a device trace, ``control.py`` the
comparison's control and ``sweep.py`` the knee of an open-loop traffic.
Nothing here imports JAX or ``band_tpu``; ``reference/`` imports nothing
of the program either.
"""
