"""The port's kept tensors and ``torch.inference_mode()``.

Every cache that keeps a tensor (``ops/convolve`` filter spectra,
``cwt._bank_spectrum`` and ``cwt._equalizer``, ``ewt._tuple_bank``, the
scattering banks, the tick stream's Paul kernel) builds it through
``ops.constants.kept``, with inference mode off.  Each case runs in both
orders on a 2x1024 float64 CPU signal (a 2x32x32 image for
``scattering2d``), each from empty caches:

* inference first: the call under ``torch.inference_mode()``, then the same
  call on an input that requires grad and its backward;
* grad first: the backward, then the call under inference mode (equal to the
  first call's output), then the backward again (equal bit for bit).

The gradient of ``sum(weights * output)`` is held to ``jax.grad`` of the
JAX package's ``backend="jnp"`` call (its plain path) within 1e-12 of the
largest gradient entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import finance as jf
from vectorwave_tpu_torch import finance as tf
from vectorwave_tpu_torch.finance import incremental as t_incremental
from vectorwave_tpu_torch.kernels import modwt_bank, modwt_composite
from vectorwave_tpu_torch.ops import convolve
from vectorwave_tpu_torch.transforms import cwt as t_cwt
from vectorwave_tpu_torch.transforms import ewt as t_ewt
from vectorwave_tpu_torch.transforms import scattering as t_scat
from vectorwave_tpu_torch.transforms import scattering2d as t_scat2

TOL = 1e-12
SEED = 23
SCALES = (2.0, 4.0, 8.0)
BOUNDS = (0.1, 0.3)
TICKS, WINDOW = 24, 8

#: the lru caches whose tensors go through ``kept``
KEPT_CACHES = (
    t_cwt._bank_spectrum, t_cwt._equalizer, t_ewt._tuple_bank, t_scat._device_bank,
    t_scat2._device_bank, t_incremental._kernel_tensor, modwt_composite._device_taps,
    modwt_bank._device_runs,
)


def _multilevel(pkg, x, **kw):
    r = pkg.modwt_multilevel(x, "db32", levels=2, **kw)
    return [*r.details, r.approx]


def _icwt(pkg, x, boundary):
    return pkg.icwt(pkg.cwt(x, SCALES, "morl", boundary=boundary), "morl")


def _ticks(pkg, prices, init, update, **kw):
    state = init(window=WINDOW, **kw)
    scores = []
    for i in range(TICKS):
        state, m = update(state, prices[i])
        scores.append(m.crash_score)
    return scores


#: name -> (the port's call, the JAX call), each input -> a list of outputs.
#: ``modwt_multilevel`` db32 J=2 takes the FFT route on the CPU (64 taps,
#: 1024 samples), as does ``modwt``; ``icwt`` reaches both CWT caches.
CASES = {
    "modwt_multilevel_fft": (lambda x: _multilevel(vt, x),
                             lambda x: _multilevel(vw, x, backend="jnp")),
    "modwt": (lambda x: list(vt.modwt(x, "db32")), lambda x: list(vw.modwt(x, "db32"))),
    "cwt_zero": (lambda x: [vt.cwt(x, SCALES, "morl", boundary="zero").coeffs],
                 lambda x: [vw.cwt(x, SCALES, "morl", boundary="zero").coeffs]),
    "cwt_periodic": (lambda x: [vt.cwt(x, SCALES, "morl", boundary="periodic").coeffs],
                     lambda x: [vw.cwt(x, SCALES, "morl", boundary="periodic").coeffs]),
    "icwt_zero": (lambda x: [_icwt(vt, x, "zero")], lambda x: [_icwt(vw, x, "zero")]),
    "icwt_periodic": (lambda x: [_icwt(vt, x, "periodic")],
                      lambda x: [_icwt(vw, x, "periodic")]),
    "ewt": (lambda x: [vt.ewt(x, BOUNDS)], lambda x: [vw.ewt(x, BOUNDS)]),
    "scattering1d": (lambda x: [vt.scattering1d(x, J=3, Q=2).feature_vector()],
                     lambda x: [vw.scattering1d(x, J=3, Q=2).feature_vector()]),
    "scattering2d": (
        lambda x: [vt.scattering2d(x.reshape(2, 32, 32), J=2, L=4).feature_vector()],
        lambda x: [vw.scattering2d(x.reshape(2, 32, 32), J=2, L=4).feature_vector()]),
    "tick_stream": (
        lambda x: _ticks(vt, 100.0 + x[0, :TICKS], tf.incremental_wavelet_init,
                         tf.incremental_wavelet_update, dtype=torch.float64, device="cpu"),
        lambda x: _ticks(vw, 100.0 + x[0, :TICKS], jf.incremental_wavelet_init,
                         jf.incremental_wavelet_update, dtype=jnp.float64)),
}


def _signal() -> np.ndarray:
    return np.random.default_rng(SEED).standard_normal((2, 1024))


def _weights(outs) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 1)
    return [rng.standard_normal(tuple(o.shape)) for o in outs]


def _loss(outs, weights, lib):
    return sum(lib.sum(lib.real(o) * w) if lib is jnp else (o.real * torch.from_numpy(w)).sum()
               for o, w in zip(outs, weights))


@pytest.fixture
def empty_caches():
    def clear():
        for cache in KEPT_CACHES:
            cache.cache_clear()
        convolve._SPECTRA.clear()
        convolve._TAPS.clear()

    clear()
    yield
    clear()


def _torch_grad(fn, x0, weights):
    x = torch.tensor(x0, requires_grad=True)
    outs = fn(x)
    _loss(outs, weights, torch).backward()
    return x.grad, [o.detach() for o in outs]


def _inference(fn, x0):
    with torch.inference_mode():
        return [o.clone() for o in fn(torch.tensor(x0))]


@pytest.mark.parametrize("order", ["inference_first", "grad_first"])
@pytest.mark.parametrize("case", list(CASES))
def test_a_kept_tensor_serves_inference_and_autograd(empty_caches, case, order):
    ported, reference = CASES[case]
    x0 = _signal()
    weights = _weights(reference(jnp.asarray(x0)))
    if order == "inference_first":
        inferred = _inference(ported, x0)
        grad, outs = _torch_grad(ported, x0, weights)
    else:
        grad, outs = _torch_grad(ported, x0, weights)
        inferred = _inference(ported, x0)
        again, _ = _torch_grad(ported, x0, weights)
        assert torch.equal(again, grad)
    assert all(torch.equal(a, b) for a, b in zip(inferred, outs))
    want = np.asarray(jax.grad(lambda z: _loss(reference(z), weights, jnp))(jnp.asarray(x0)))
    assert np.max(np.abs(grad.numpy() - want)) <= TOL * np.max(np.abs(want))
    assert np.max(np.abs(want)) > 0


def test_every_tensor_cache_is_built_outside_inference_mode(empty_caches):
    """A cache entry made under inference mode is a normal tensor."""
    with torch.inference_mode():
        spec = convolve._filter_spectrum((0.5, 0.5), 1, 16, torch.complex128,
                                          torch.device("cpu"))
        bank = t_cwt._bank_spectrum(vt.wavelet("morl"), SCALES, 64, True, torch.complex128,
                                    torch.device("cpu"))
    assert not spec.is_inference() and not bank.is_inference()
