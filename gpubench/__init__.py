"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one cell
(a model configuration under a traffic mix) a run, driven by the files
under this directory.  ``python3 gpubench/run.py --help`` runs one."""
