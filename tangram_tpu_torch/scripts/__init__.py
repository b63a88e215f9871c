"""Tools above the public API of ``tangram_tpu_torch``, the port of the
repo's ``scripts/`` (each runs as ``python -m
tangram_tpu_torch.scripts.<name>``, on the card unless ``--device cpu`` is
given where the tool trains):

* ``fuzz_paths``: random shapes, loss weights, gene masks and learning
  rates through the reference loop, the fused loop, the sharded fused loop
  and a chunked sharded run, which must agree;
* ``fuzz_tuner``: random search spaces and the four search modes through
  ``mapping_hyperparameter_tuning``;
* ``gen_api_docs``: the markdown API reference under
  ``docs/reference_torch/`` (``--check`` reports stale pages);
* ``gen_tutorial_notebook``: ``notebooks/tutorial_tangram_tpu_torch.ipynb``.

Importing a tool runs nothing.
"""
