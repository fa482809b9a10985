"""Bytes of tensors given by shape and element size, for the roofline
files: every input read once and every output written once."""

import math


def nbytes(*shapes_and_sizes) -> int:
    return sum(math.prod(shape) * size for shape, size in shapes_and_sizes)
