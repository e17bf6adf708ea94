"""Where a cell's analyses read their frames, one module a traffic
``"source"``: ``Source(cfg, traffic, frames, topology, dimensions)``
with ``universe()`` (the ``Universe`` an analysis is handed),
``release(u)`` (after the analysis) and ``close()``."""
