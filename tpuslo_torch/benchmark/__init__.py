"""The port's serving benches: the front-door gate and the router's
scale-out gate (the counterparts of ``tpuslo/benchmark/frontdoor_bench.py``
and ``router_bench.py``)."""
