"""Frame models, one module a system, found by a configuration's
``"system"`` key (see :mod:`portbench.frames`)."""
