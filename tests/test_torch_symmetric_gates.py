"""Port parity: symmetric calls that the card's kernels refuse, on the CPU.

The symmetric kernels serve a call only if their windows fit shared memory
and the synthesis splice windows do not overlap.  Those gates belong to the
card: a CPU tensor runs the plain symmetric cascade and inverse at every
shape the JAX package serves (its entry points take their jnp path there).
The JAX reference runs jitted in float64; the tolerance is 1e-12 (the same
arithmetic in another order, values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels.modwt_pallas import fused_synthesis as jax_fused_synthesis
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms

torch.set_num_threads(1)

TOL_F64 = 1e-12


def _maxdiff(got, want):
    return max(float(np.max(np.abs(g.detach().numpy() - np.asarray(w, np.float64))))
               for g, w in zip(got, want))


def _tensor(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,levels,n,analysis_refused", [
    ("db4", 3, 40, False), ("db20", 8, 20000, False), ("db38", 9, 40000, True),
])
def test_cpu_tensors_pass_the_cards_gates_and_match_jax_jnp_float64(
        name, levels, n, analysis_refused):
    w = vt.wavelet(name)
    assert not ms.synthesis_fits(w.filter_length, ms.symmetric_level_ops(w, levels), n)
    assert ms.analysis_fits(w.filter_length, levels) != analysis_refused
    x = np.random.default_rng(12).standard_normal((2, n))
    want = jax.jit(lambda v: vw.modwt_multilevel(
        v, name, levels=levels, boundary="symmetric", backend="jnp"))(jnp.asarray(x))
    td, ta = vt.fused_analysis(torch.from_numpy(x), name, levels=levels,
                               boundary="symmetric")
    assert _maxdiff((*td, ta), (*want.details, want.approx)) <= TOL_F64
    jy = jax.jit(lambda r: vw.imodwt_multilevel(
        r, name, boundary="symmetric", backend="jnp"))(want)
    ty = vt.fused_synthesis([_tensor(d) for d in want.details], _tensor(want.approx),
                            name, boundary="symmetric")
    assert _maxdiff((ty,), (jy,)) <= TOL_F64
    rt = vt.modwt_roundtrip_fused(torch.from_numpy(x), name, levels=levels,
                                  boundary="symmetric")
    assert _maxdiff((rt,), (jy,)) <= TOL_F64


@pytest.mark.parametrize("name,levels,n", [("db4", 3, 40), ("db38", 9, 40000)])
def test_off_the_cpu_the_gates_still_refuse(name, levels, n):
    # a meta tensor stands for a CUDA one: it is not on the CPU
    planes = [torch.zeros(2, n, device="meta") for _ in range(levels + 1)]
    with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
        vt.fused_synthesis(planes[:-1], planes[-1], name, boundary="symmetric")
    if name == "db38":
        with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
            vt.fused_analysis(planes[0], name, levels=levels, boundary="symmetric")


def test_a_signal_shorter_than_the_filter_raises_in_both_packages():
    planes = np.zeros((5, 2, 64), np.float32)
    with pytest.raises(vw.errors.InvalidArgumentError):
        jax_fused_synthesis([jnp.asarray(p) for p in planes[:-1]], jnp.asarray(planes[-1]),
                            "sym8", boundary="symmetric", interpret=True)
    with pytest.raises(InvalidArgumentError):
        vt.fused_synthesis([_tensor(p) for p in planes[:-1]], _tensor(planes[-1]), "sym8",
                           boundary="symmetric")
