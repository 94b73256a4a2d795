"""The paper's four example drivers in the port (counterparts of the
repository's ``examples/*.py``), each run as ``python -m
repro_torch.examples.<name>``:

* ``quickstart``: GWT-2 and GWT-3 against Adam on a tiny LLaMA, with the
  exact optimizer-state bytes;
* ``compare_optimizers``: the paper's Table II proxy, Adam, MUON, GaLore,
  APOLLO, Fira and GWT in four variants, final loss and analytic state MiB;
* ``pretrain``: llama-130m pre-training with checkpoint and restart,
  through ``repro_torch.launch.train``;
* ``serve_batched``: greedy decode over KV caches, cross-checked against
  the full forward pass.

Each runs on the card unless ``--device cpu`` is given, and draws its
weights from an explicit ``torch.Generator``.
"""
