"""Where a cell's analyses read their frames, one module a traffic
``"source"``: ``Source(cfg, traffic, frames, topology, dimensions)``
with ``universe()`` (the ``Universe`` an analysis is handed),
``release(u)`` (after the analysis) and ``close()``.

Two attributes are optional.  ``analysis_kwargs``: keyword arguments
the harness passes to every analysis's ``run`` (none when absent).
``resident``: True where the source keeps the staged blocks on the
card; set-up then fills them by whole analyses
(:func:`portbench.harness.fill`) in place of the warm-up on a prefix,
and a window analysis that stages a block is an error."""
