"""Exact float64 reference ("oracle") implementations.

This subpackage is the behavioral ground truth for the device kernels: a
vectorized numpy re-statement of the reference scoring semantics
(takashi310/colormipsearch) using IEEE float64 with the same operation
order, so its results are bit-identical to the Java implementation.

It is used (a) by the test-suite as an independent oracle, and (b) at
runtime to resolve the rare pixel pairs whose match verdict falls inside
the floating-point ambiguity band of the fast device predicates.
"""

from colormipsearch_tpu.oracle.pixel import (  # noqa: F401
    classify_rgb,
    pixel_gap,
    PixelMatchOracle,
)
