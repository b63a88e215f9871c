"""The fused step on one device and on a mesh is one function
(``ops/fused_step.py``'s ``_cotangents``), over no axes or over the mesh's:
a ``("cell",)`` mesh of one ``gloo`` process must store the bits of the
single-device fused loop. ``tests/_parallel_worker.py`` suite ``"one"``
trains each case both ways in one spawned process on the CPU (the kernels'
plain twins), one torch thread; here the parameters, the optimizer's
moments and every history entry after ten epochs are compared bit for bit.
"""

import numpy as np
import pytest

import _parallel_worker as pw


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    return pw.run(str(tmp_path_factory.mktemp("gloo_one")), suite="one", world=1)[0]


@pytest.mark.parametrize("name", list(pw.ONE_CASES))
def test_mesh_of_one_stores_the_single_device_bits(fits, name):
    out = fits[name]
    assert "error" not in out, out.get("error")
    one, mesh = out["one"], out["mesh"]
    assert len(one["params"]) == len(mesh["params"])
    for got, want in zip(mesh["params"] + mesh["moments"], one["params"] + one["moments"]):
        np.testing.assert_array_equal(got, want)
    assert sorted(mesh["hist"]) == sorted(one["hist"])
    for key, want in one["hist"].items():
        assert want.shape == (pw.ONE_EPOCHS,), key
        np.testing.assert_array_equal(mesh["hist"][key], want, err_msg=key)
