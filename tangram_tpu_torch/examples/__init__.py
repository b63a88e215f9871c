"""Runnable tutorials of ``tangram_tpu_torch``, the port of the repo's
``examples/`` (each runs as ``python -m tangram_tpu_torch.examples.<name>``,
on the card unless ``--device cpu`` is given):

* ``tutorial_mapping``: map, project, LOO cross-validation, AUC and plots;
* ``tutorial_deconvolution``: constrained mapping and segmentation-level
  deconvolution;
* ``tutorial_atlas_mesh``: a mapping over a mesh of processes (under
  ``torchrun``), then checkpointed training cut and resumed;
* ``tutorial_fault_tolerant_sweep``: cross-validation and the adaptive
  tuner over a mesh, each journaled and resumed.

Importing a tutorial runs nothing.
"""
