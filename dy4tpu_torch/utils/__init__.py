"""Host-side utilities of the port: stream I/O (a copy of ``dy4tpu``'s
``utils/io.py``) and checkpointing."""
