"""``fit_mapping`` with the five graph terms, the port against the JAX
package.

15 epochs with all five terms on, on a dense and on a k-NN spot graph
(``tests/test_torch_graph_terms.py::make_problem``), on each of the port's
loops: the fused loop (the kernels' plain twins on the CPU), the
materialized reference loop, the autograd loop through ``MapperCore``
(``fused=False``) and the fused Adafactor loop; each against the JAX
package's fused Pallas path (interpret mode) and, for Adam, its XLA path.

Tolerances: the loss histories (every graph term's among them) at rtol
1e-5 and the logits at atol 1e-4 (measured at most 1.2e-6 and 1.6e-5;
``tests/test_fused_step.py::test_fused_with_spatial_regularizers`` allows
5e-4 / 5e-5 and 3e-3 between two JAX paths); Adafactor at rtol 5e-4 and
atol 3e-3 (measured 6.7e-5 and 5.7e-4: its update is linear in the
gradient and passes rounding on undamped; ``tests/test_adafactor.py:177-191``
allows 5e-3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tangram_tpu.models import mapper as jm
from tangram_tpu.ops import losses as jl
from tangram_tpu_torch.convert import mapper_data_from_jax
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import losses as tl

from test_torch_graph_terms import GRAPH_LAMBDAS, close, make_problem

EPOCHS = 15
FIT_LAMBDAS = dict(GRAPH_LAMBDAS, lambda_g1=1.0, lambda_d=1.0)


@functools.lru_cache(maxsize=None)
def jax_fit(kind, impl, optimizer="adam"):
    M, jdata = make_problem(4, kind, c=30, s=48, g=8, n_types=3)
    p, h = jm.fit_mapping(jnp.asarray(M), jdata, jl.LossWeights(**FIT_LAMBDAS), EPOCHS,
                          0.1, impl=impl, fused=True, optimizer=optimizer)
    return M, jdata, np.asarray(p), {k: np.asarray(v) for k, v in h.items()}


# (the port's loop: impl, fused, optimizer; the JAX runs it is held to; the
# losses' rtol and the logits' atol)
LOOPS = {
    "fused": ("fused", True, "adam", ("pallas", "xla"), 1e-5, 1e-4),
    "reference": ("reference", True, "adam", ("pallas", "xla"), 1e-5, 1e-4),
    "fused=False": ("fused", False, "adam", ("pallas", "xla"), 1e-5, 1e-4),
    "adafactor": ("fused", True, "adafactor", ("pallas",), 5e-4, 3e-3),
}


@pytest.mark.parametrize("kind", ["dense", "knn"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_fit_mapping_with_the_graph_terms_matches_jax(loop, kind):
    impl, fused, optimizer, jax_impls, loss_rtol, m_atol = LOOPS[loop]
    for jax_impl in jax_impls:
        M, jdata, p_j, h_j = jax_fit(kind, jax_impl, optimizer)
        p_t, h_t = tm.fit_mapping(torch.from_numpy(M.copy()), mapper_data_from_jax(jdata),
                                  tl.LossWeights(**FIT_LAMBDAS), EPOCHS, 0.1, impl=impl,
                                  fused=fused, optimizer=optimizer)
        assert set(h_t) == set(tm.TERM_KEYS)
        for key in ("total_loss", "main_loss", "kl_reg") + tuple(tm.GRAPH_TERM_KEYS):
            assert np.isfinite(h_t[key].numpy()).all(), key
            close(h_t[key].numpy(), h_j[key], rtol=loss_rtol, atol=0)
        close(p_t.numpy(), p_j, rtol=0, atol=m_atol)
