"""Compute ops of the port (PyTorch): superposition
(:mod:`.align`), RMSD series (:mod:`.rmsd`), streaming moments (:mod:`.moments`), the fused
aligned-moments path (:mod:`.fused_rmsf`, :mod:`.fused_planar`), box
matrices and volumes (:mod:`._boxmat`), pair distances and the generic
RDF histogram (:mod:`.distances`), the pair-histogram kernel's wrapper
and batch function (:mod:`.fused_distances`), and the serial float64
NumPy oracle (:mod:`.host`).  Submodules are imported on use.

Only submodules are exported, as in the JAX package: re-exporting
functions here would shadow the ``rmsd`` module with the ``rmsd``
function."""

__all__ = ["align", "host", "moments", "rmsd"]


def __getattr__(name):
    # lazy, so that ``ops.host`` and ``ops._boxmat`` import without torch
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
