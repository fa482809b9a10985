"""Receiver pipeline of the port: ``receiver`` (the per-block step over
a ``[channels, block]`` batch) and ``convert`` (params and state to and
from ``dy4tpu``'s NamedTuples).  Nothing is imported eagerly."""
