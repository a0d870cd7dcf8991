"""vectorwave_tpu_torch — the PyTorch/CUDA port of vectorwave_tpu.

What is ported: every discrete wavelet family (haar, db, sym, coif, the
biorthogonal and reverse biorthogonal splines, discrete Meyer,
Battle-Lemarie) and every continuous one with the registry's queries, the
continuous wavelet transform (``cwt`` with its kernel-direct tier on the
filter-bank kernel, ``icwt``, band reconstruction, ``modwt_based_icwt``, the
scale tools and selectors), single- and multi-level MODWT with periodic, zero and symmetric boundaries, the SWT
facade, the decimated DWT, padding strategies, single- and multi-level
denoising (the fused denoise differentiable on the card), the exact
precision tier (double-float planes, round trips within 1e-10), the 2-D
family (MODWT2, DWT2, ``denoise2`` and the 2-D SWT), wavelet packets (WPT,
MODWPT, best basis, ``denoise_packet``) and the dual-tree complex wavelet
transform (``dtcwt``, ``dtcwt_denoise``), streaming (block streaming with
carried state, sliding windows, ring-buffer ingest through a native C++
ring, the streaming denoiser; ``streaming``, ``native``), the parallel tier
(meshes of torch devices, the batch facade, long-signal and 2-D tiling with
halo exchange, the sharded exact tier, the host x chip layout;
``parallel``), and the kernel tier behind them: ten hand-written CUDA
kernels for Hopper (multi-level analysis with an optional head splice and
an external left halo, synthesis with an external right halo, fused
denoise with a stream mode, the symmetric synthesis with its adjoint, the
2-D analysis and synthesis levels and the general filter bank's analysis
and synthesis, in fp32; exact analysis and synthesis with their halos in
fp64) with their plain PyTorch versions.  On top of the CWT: the
tiled CWT (``parallel.cwt_tiled``, ``cwt_tiled_2d``), cross-wavelet
analysis (coherence, phase synchronization, ridges), significance tests,
synchrosqueezing, matching pursuit (``optimize``) and the financial
analyzers (``finance``).  The 1-D analysis modules: the wavelet variance,
covariance and correlation with the online variance stream, long memory
(Hurst exponent, variance change test), multifractal leaders, the lifting
DWT with its lossless integer mode, the empirical wavelet transform and the
1-D scattering network; and the 2-D CWT (``cwt2``, ``icwt2``) with 2-D
scattering.  The decimated 2-D trees (the packet quadtree with its best
basis and denoisers, the 2-D dual tree with bivariate shrinkage), the
sparse solvers (FISTA, basis-pursuit denoising, inpainting, compressed
sensing) and ForWaRD deconvolution (``optimize``), block shrinkage, and the
infrastructure: the cost model (``cost_model``), logging and profiling
(``observability``), ``TransformConfig``, ``enable_compilation_cache`` and
``get_performance_info``.

The package imports ``torch``, ``numpy`` and ``mpmath`` and never JAX or
``vectorwave_tpu``.  Inputs and outputs are ``[..., N]`` tensors; the device
is the input's (``[..., H, W]`` for the 2-D family).  Only what is ported
is exported.
"""

from . import (
    config,
    convert,
    cost_model,
    errors,
    finance,
    kernels,
    native,
    observability,
    optimize,
    parallel,
    streaming,
)
from .config import (
    TransformConfig,
    enable_compilation_cache,
    get_backend,
    get_fused_precision,
    get_sigma_estimator,
    set_backend,
    set_fused_precision,
    set_sigma_estimator,
)
from .denoise.denoiser import (
    denoise,
    denoise_block,
    denoise_fixed,
    denoise_multilevel,
    threshold_coeffs,
)
from .denoise.dtcwt_shrink import dtcwt2_denoise, dtcwt_denoise
from .denoise.packet import denoise_packet, denoise_packet2
from .errors import (
    ErrorCode,
    InvalidArgumentError,
    InvalidConfigurationError,
    InvalidSignalError,
    InvalidStateError,
    VectorWaveError,
)
from .kernels import (
    fused_analysis,
    fused_denoise_multilevel,
    fused_synthesis,
    kernel_available,
    modwt_roundtrip_fused,
)
from .kernels.modwt_exact import (
    imodwt_multilevel_exact,
    modwt_multilevel_exact,
    modwt_roundtrip_exact,
)
from .ops.dwt import (
    DWTResult,
    WavedecResult,
    dwt,
    idwt,
    max_dwt_levels,
    wavedec,
    waverec,
)
from .ops.facade import PerformanceInfo, get_performance_info
from .ops.thresholds import (
    BLOCK_LAMBDA,
    apply_threshold,
    bayes_threshold,
    block_shrink,
    fdr_threshold,
    hard_threshold,
    mad_sigma,
    median_magnitude,
    minimax_threshold,
    select_threshold,
    soft_threshold,
    sure_threshold,
    universal_threshold,
)
from .padding import STRATEGIES as PADDING_STRATEGIES
from .padding import adaptive_strategy, pad_signal
from .transforms.cwt import (
    CWTConfig,
    CWTResult,
    ScaleSelectionConfig,
    cwt,
    estimate_scale_count,
    frequency_range_of_scales,
    frequency_to_scale,
    icwt,
    reconstruct_band,
    reconstruct_frequency_band,
    scale_to_frequency,
    scales_dyadic,
    scales_linear,
    scales_log,
    select_scales_adaptive,
    select_scales_optimal,
    select_scales_signal_adaptive,
)
from .transforms.cwt2 import (
    ContinuousWavelet2D,
    CWT2Result,
    cwt2,
    gaussian2,
    icwt2,
    mexican_hat2,
    morlet2,
    scale_to_frequency2,
    scales_for_frequencies2,
)
from .transforms.cwt_modwt_inverse import modwt_based_icwt
from .transforms.ewt import ewt, ewt_boundaries, ewt_hilbert, iewt
from .transforms.lifting import (
    LIFTING_SCHEMES,
    LiftingScheme,
    LiftingStep,
    get_lifting_scheme,
    lifting_dwt,
    lifting_dwt_int,
    lifting_idwt,
    lifting_idwt_int,
    lifting_wavedec,
    lifting_wavedec_int,
    lifting_waverec,
    lifting_waverec_int,
)
from .transforms.longmemory import (
    HurstResult,
    VarianceChangeResult,
    hurst_exponent,
    variance_change_test,
)
from .transforms.multifractal import (
    MultifractalResult,
    multifractal_spectrum,
    wavelet_leaders,
)
from .transforms.scattering import ScatteringResult, scattering1d, scattering_filterbank
from .transforms.scattering2d import Scattering2DResult, scattering2d
from .transforms.variance import (
    VarianceStreamState,
    WaveletVarianceResult,
    variance_stream_init,
    variance_stream_result,
    variance_stream_update,
    wavelet_correlation,
    wavelet_covariance,
    wavelet_variance,
)
from .optimize import (
    DeconvolutionResult,
    MPResult,
    SparseRecovery,
    bpdn,
    deconvolve,
    deconvolve2,
    fista,
    inpaint,
    inpaint2,
    matching_pursuit,
    sparse_recover,
)
from .transforms.significance import (
    SignificanceResult,
    ar1_coefficient,
    coherence_significance,
    cone_of_influence,
    phase_randomized_surrogates,
    significance_levels,
    significant_power,
)
from .transforms.sst import SSTResult, dominant_frequencies, extract_mode, isst, synchrosqueeze
from .transforms.xwt import (
    CoherenceResult,
    RidgeResult,
    cross_wavelet,
    extract_ridge,
    instantaneous_frequency,
    phase_synchronization,
    wavelet_coherence,
)
from .transforms.dtcwt import (
    DTCWTResult,
    coefficient_delay,
    dtcwt,
    dtcwt_max_levels,
    idtcwt,
)
from .transforms.dtcwt2 import DTCWT2Result, dtcwt2, idtcwt2
from .transforms.modwt import MODWTResult, imodwt, modwt
from .transforms.multilevel import (
    MAX_DECOMPOSITION_LEVELS,
    ExactMODWTResult,
    MultiLevelMODWTResult,
    imodwt_multilevel,
    max_levels,
    modwt_multilevel,
    resolve_tolerance,
)
from .transforms.packets import (
    WaveletPacketTree,
    basis_coefficients,
    best_basis,
    frequency_order,
    imodwpt,
    iwpt,
    modwpt,
    packet_frequency_bands,
    reconstruct_basis,
    wpt,
)
from .transforms.packets2d import (
    WaveletPacket2DTree,
    basis_coefficients2,
    best_basis2,
    best_basis_denoise2,
    iwpt2,
    packet_frequency_bands2,
    reconstruct_basis2,
    wpt2,
)
from .transforms.swt2 import SWT2Result, extract_level2, iswt2, mra2, swt2, swt2_denoise
from .transforms.swt import (
    SWTResult,
    apply_universal_threshold,
    extract_level,
    iswt,
    mra,
    swt,
    swt_denoise,
    threshold_level,
)
from .transforms.twodim import (
    DWT2Result,
    MODWT2Result,
    MultiLevelMODWT2Result,
    denoise2,
    dwt2,
    idwt2,
    imodwt2,
    imodwt2_multilevel,
    modwt2,
    modwt2_multilevel,
    wavedec2,
    waverec2,
)
from .wavelets.base import (
    ContinuousWavelet,
    DiscreteWavelet,
    TransformType,
    Wavelet,
    WaveletType,
)
from .wavelets.registry import (
    as_wavelet,
    available_wavelets,
    is_compatible,
    recommended_transform,
    register_wavelet,
    supported_transforms,
    wavelet,
    wavelets_in_family,
    wavelets_of_type,
)

__version__ = "0.1.0"

__all__ = [
    "BLOCK_LAMBDA",
    "CWT2Result",
    "CWTConfig",
    "CWTResult",
    "CoherenceResult",
    "ContinuousWavelet",
    "ContinuousWavelet2D",
    "DTCWT2Result",
    "DTCWTResult",
    "DWT2Result",
    "DWTResult",
    "DeconvolutionResult",
    "DiscreteWavelet",
    "ErrorCode",
    "ExactMODWTResult",
    "HurstResult",
    "InvalidArgumentError",
    "InvalidConfigurationError",
    "InvalidSignalError",
    "InvalidStateError",
    "LIFTING_SCHEMES",
    "LiftingScheme",
    "LiftingStep",
    "MAX_DECOMPOSITION_LEVELS",
    "MODWT2Result",
    "MODWTResult",
    "MPResult",
    "MultiLevelMODWT2Result",
    "MultiLevelMODWTResult",
    "MultifractalResult",
    "PADDING_STRATEGIES",
    "PerformanceInfo",
    "RidgeResult",
    "SSTResult",
    "SWT2Result",
    "SWTResult",
    "ScaleSelectionConfig",
    "Scattering2DResult",
    "ScatteringResult",
    "SignificanceResult",
    "SparseRecovery",
    "TransformConfig",
    "TransformType",
    "VarianceChangeResult",
    "VarianceStreamState",
    "VectorWaveError",
    "WavedecResult",
    "Wavelet",
    "WaveletPacket2DTree",
    "WaveletPacketTree",
    "WaveletType",
    "WaveletVarianceResult",
    "__version__",
    "adaptive_strategy",
    "apply_threshold",
    "apply_universal_threshold",
    "ar1_coefficient",
    "as_wavelet",
    "available_wavelets",
    "basis_coefficients",
    "basis_coefficients2",
    "bayes_threshold",
    "best_basis",
    "best_basis2",
    "best_basis_denoise2",
    "block_shrink",
    "bpdn",
    "coefficient_delay",
    "coherence_significance",
    "cone_of_influence",
    "config",
    "convert",
    "cost_model",
    "cross_wavelet",
    "cwt",
    "cwt2",
    "deconvolve",
    "deconvolve2",
    "denoise",
    "denoise2",
    "denoise_block",
    "denoise_fixed",
    "denoise_multilevel",
    "denoise_packet",
    "denoise_packet2",
    "dominant_frequencies",
    "dtcwt",
    "dtcwt2",
    "dtcwt2_denoise",
    "dtcwt_denoise",
    "dtcwt_max_levels",
    "dwt",
    "dwt2",
    "enable_compilation_cache",
    "errors",
    "estimate_scale_count",
    "ewt",
    "ewt_boundaries",
    "ewt_hilbert",
    "extract_level",
    "extract_level2",
    "extract_mode",
    "extract_ridge",
    "fdr_threshold",
    "finance",
    "fista",
    "frequency_order",
    "frequency_range_of_scales",
    "frequency_to_scale",
    "fused_analysis",
    "fused_denoise_multilevel",
    "fused_synthesis",
    "gaussian2",
    "get_backend",
    "get_fused_precision",
    "get_lifting_scheme",
    "get_performance_info",
    "get_sigma_estimator",
    "hard_threshold",
    "hurst_exponent",
    "icwt",
    "icwt2",
    "idtcwt",
    "idtcwt2",
    "idwt",
    "idwt2",
    "iewt",
    "imodwpt",
    "imodwt",
    "imodwt2",
    "imodwt2_multilevel",
    "imodwt_multilevel",
    "imodwt_multilevel_exact",
    "inpaint",
    "inpaint2",
    "instantaneous_frequency",
    "is_compatible",
    "isst",
    "iswt",
    "iswt2",
    "iwpt",
    "iwpt2",
    "kernel_available",
    "kernels",
    "lifting_dwt",
    "lifting_dwt_int",
    "lifting_idwt",
    "lifting_idwt_int",
    "lifting_wavedec",
    "lifting_wavedec_int",
    "lifting_waverec",
    "lifting_waverec_int",
    "mad_sigma",
    "matching_pursuit",
    "max_dwt_levels",
    "max_levels",
    "median_magnitude",
    "mexican_hat2",
    "minimax_threshold",
    "modwpt",
    "modwt",
    "modwt2",
    "modwt2_multilevel",
    "modwt_based_icwt",
    "modwt_multilevel",
    "modwt_multilevel_exact",
    "modwt_roundtrip_exact",
    "modwt_roundtrip_fused",
    "morlet2",
    "mra",
    "mra2",
    "multifractal_spectrum",
    "native",
    "observability",
    "packet_frequency_bands",
    "packet_frequency_bands2",
    "pad_signal",
    "parallel",
    "phase_randomized_surrogates",
    "phase_synchronization",
    "recommended_transform",
    "reconstruct_band",
    "reconstruct_basis",
    "reconstruct_basis2",
    "reconstruct_frequency_band",
    "register_wavelet",
    "resolve_tolerance",
    "scale_to_frequency",
    "scale_to_frequency2",
    "scales_dyadic",
    "scales_for_frequencies2",
    "scales_linear",
    "scales_log",
    "scattering1d",
    "scattering2d",
    "scattering_filterbank",
    "select_scales_adaptive",
    "select_scales_optimal",
    "select_scales_signal_adaptive",
    "select_threshold",
    "set_backend",
    "set_fused_precision",
    "set_sigma_estimator",
    "significance_levels",
    "significant_power",
    "soft_threshold",
    "sparse_recover",
    "streaming",
    "supported_transforms",
    "sure_threshold",
    "swt",
    "swt2",
    "swt2_denoise",
    "swt_denoise",
    "synchrosqueeze",
    "threshold_coeffs",
    "threshold_level",
    "universal_threshold",
    "variance_change_test",
    "variance_stream_init",
    "variance_stream_result",
    "variance_stream_update",
    "wavedec",
    "wavedec2",
    "wavelet",
    "wavelet_coherence",
    "wavelet_correlation",
    "wavelet_covariance",
    "wavelet_leaders",
    "wavelet_variance",
    "wavelets_in_family",
    "wavelets_of_type",
    "waverec",
    "waverec2",
    "wpt",
    "wpt2",
]
