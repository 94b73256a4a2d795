"""The plain reference that decides a run's ``correct``: the decoder's
loss and gradients (``model``), the optimizer rules (``optim``) and the
three checked steps (``train``), in plain PyTorch.  It imports nothing of
the program under test and nothing of the JAX package."""
