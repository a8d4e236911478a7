"""Plain float32 PyTorch references of the benchmark's models, one module
per model kind (``dense``, ``moe``), sharing :mod:`.common`.  They import
nothing of the program and take nothing it made: the benchmark hands them
the weights it drew and the tokens it served."""
