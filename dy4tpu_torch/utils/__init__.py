"""Host-side utilities of the port: stream I/O (a copy of ``dy4tpu``'s
``utils/io.py``), checkpointing, gnuplot vector and PSD logging, and
profiling (``torch.profiler`` traces, the program's spans)."""
