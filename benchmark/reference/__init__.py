"""The benchmark's yardstick: plain NumPy/PyTorch that imports nothing of
the program (``tangram_tpu_torch``) and nothing of JAX.

* :mod:`.generators` — the data: a frozen copy of the repo's pair generator
  and the sparse pair built on it;
* :mod:`.work` — the step's bytes and operations, and the card's peaks;
* :mod:`.tangram` — the plain Tangram mapping (preprocessing, init, loss,
  Adam) that decides ``correct``.
"""
