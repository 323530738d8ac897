"""The frozen FLOP and byte arithmetic of the kernels (``k1``, ``k2``) and
of each algorithm's dispatch (``<algorithm>.py``), from shapes alone."""
