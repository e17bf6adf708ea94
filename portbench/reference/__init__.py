"""Plain references, one module an analysis, found by a configuration's
``"analysis"`` key.  They import nothing of the program: they work
every answer out again, in float64, from the frames the benchmark made
(:mod:`portbench.frames`), and compare the program's answers with it.
"""
