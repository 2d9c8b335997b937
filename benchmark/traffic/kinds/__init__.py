"""Traffic kinds: one module a kind, found by the ``kind`` of a traffic
file. Each defines ``run(ctx) -> dict``."""
