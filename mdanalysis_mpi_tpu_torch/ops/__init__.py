"""Compute ops of the port (PyTorch): superposition
(:mod:`.align`), RMSD series (:mod:`.rmsd`), streaming moments (:mod:`.moments`), the fused
aligned-moments path (:mod:`.fused_rmsf`, :mod:`.fused_planar`), box
matrices and volumes (:mod:`._boxmat`), pair distances and the generic
RDF histogram (:mod:`.distances`), the pair-histogram kernel's wrapper
and batch function (:mod:`.fused_distances`), and the serial float64
NumPy oracle (:mod:`.host`).  Submodules are imported on use."""
