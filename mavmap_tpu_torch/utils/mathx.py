"""Small math helpers (counterpart of reference src/util/math.{h,cc})."""

import math

import numpy as np


def median(values):
    """Median matching reference util/math.cc:12 (mean of middle two)."""
    return float(np.median(np.asarray(values)))


def rel2abs_threshold(threshold, total):
    """Relative [0,1) fraction-of-total or absolute >= 1 threshold.

    Reference util/math.cc:29: values < 1 are fractions of `total`
    (rounded up), values >= 1 are absolute counts.
    """
    if threshold < 1:
        return int(math.ceil(threshold * total))
    return int(threshold)
