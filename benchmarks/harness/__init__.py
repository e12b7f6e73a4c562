"""The general part of the port's benchmark: the manifest, the traffic
generator, the closed loop, the trace reader, the yardstick and the
correctness check.  What belongs to one configuration, traffic mix,
metric or cell lives in files of its own beside this package
(``configs/``, ``reference/``, ``traffic/``, ``metrics/``, ``limits/``)
and is found by the name ``BENCHMARK.json`` gives it."""
