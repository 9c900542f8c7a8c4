"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its one
command is ``bench/run.py``; see ``bench/README.md``."""
