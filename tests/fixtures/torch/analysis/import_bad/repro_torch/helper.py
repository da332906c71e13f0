"""Transitive link: stdlib-looking helper that drags numpy in."""

import numpy


def centroid(xs):
    return numpy.mean(xs)
