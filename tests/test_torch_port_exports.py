"""Every name the JAX package exports is reachable where it puts it in the
port, or is written down below as not ported yet.

The test walks every ``__init__.py`` that both packages have and, for each
name in the JAX module's ``__all__``, asserts that the port's module of the
same path has it, or that the name is on :data:`NOT_PORTED` with the reason
(ROADMAP Queue 1 holds it, or it is not queued). The list shrinks as modules
are ported; a name on it that the port has gained fails the test, so the
list cannot go stale.
"""

import importlib
import pkgutil

import pytest

import pyfilter_tpu
import pyfilter_tpu_torch

_GAUSSIAN = "ROADMAP Queue 1 item 3 (the Gaussian family)"
_BEYOND = "ROADMAP Queue 1 item 4 (methods beyond the reference)"
_INFERENCE = "ROADMAP Queue 1 item 2 (the rest of inference)"

#: (module path below the package, name) -> why the port does not have it yet
NOT_PORTED = {
    **{("", n): _GAUSSIAN for n in (
        "KalmanFilter", "ExtendedKalmanFilter", "UnscentedKalmanFilter", "CubatureKalmanFilter",
        "GaussianSumFilter", "InteractingMultipleModel", "MarkovSwitchingModel", "EnsembleKalmanFilter",
        "EnsembleTransformKalmanFilter", "Localization", "GaussianMarginalFilter")},
    **{("", n): _BEYOND for n in ("BlockParticleFilter", "RaoBlackwellizedPF", "SQMC")},
    ("", "io"): "ROADMAP Queue 1 item 5",
    ("", "parallel"): "ROADMAP Queue 1 item 6",
    ("", "enable_compile_cache"): "not queued: it exists only for XLA",
    ("", "interop"): "not queued: the numpyro bridge (no numpyro or pyro to bridge to)",
    **{("filters", n): _GAUSSIAN for n in (
        "KalmanFilter", "KalmanState", "ExtendedKalmanFilter", "EKFState", "UnscentedKalmanFilter",
        "CubatureKalmanFilter", "GaussianSumFilter", "GSFState", "InteractingMultipleModel", "IMMState",
        "MarkovSwitchingModel", "EnsembleKalmanFilter", "EnsembleTransformKalmanFilter", "Localization",
        "gaspari_cohn", "GaussianMarginalFilter", "EnKFState")},
    **{("filters", n): _BEYOND for n in (
        "BlockParticleFilter", "BlockPFState", "RaoBlackwellizedPF", "LinearSubstructure", "SQMC")},
    **{("filters.particle", n): _BEYOND for n in (
        "SQMC", "SQMCState", "VarianceEstimate", "eve_indices", "lag_ancestor_indices", "log_likelihood_variance",
        "filter_mean_variance")},
    **{("inference", n): _BEYOND for n in (
        "StorvikFilter", "StorvikResult", "NIGAutoregression", "NIGARUnknownObsVariance",
        "NIGVectorAutoregression", "PoissonGammaCounts")},
    ("inference", "PGAS"): _INFERENCE,
    **{("inference.sequential", n): _BEYOND for n in (
        "StorvikFilter", "StorvikResult", "NIGAutoregression", "NIGARUnknownObsVariance",
        "NIGVectorAutoregression", "PoissonGammaCounts")},
    **{("inference.sequential", n): _INFERENCE for n in (
        "Collector", "MeanCollector", "Standardizer", "ParameterPosterior", "collectors")},
    **{("inference.batch.mcmc", n): _INFERENCE for n in ("PGAS", "PGASResult", "csmc_sweep")},
    **{("ops", n): _BEYOND + ": ops/hilbert.py with SQMC" for n in ("hilbert_argsort", "hilbert_keys")},
}
#: JAX packages the port has no counterpart of yet
NOT_PORTED_PACKAGES = {"parallel": "ROADMAP Queue 1 item 6"}


def _shared_packages():
    out = [""]
    for info in pkgutil.walk_packages(pyfilter_tpu.__path__, "pyfilter_tpu."):
        if info.ispkg:
            out.append(info.name.removeprefix("pyfilter_tpu."))
    return out


@pytest.mark.parametrize("path", _shared_packages(), ids=lambda p: p or "<top>")
def test_port_exports_what_the_jax_package_exports(path):
    suffix = "." + path if path else ""
    jmod = importlib.import_module("pyfilter_tpu" + suffix)
    try:
        tmod = importlib.import_module("pyfilter_tpu_torch" + suffix)
    except ModuleNotFoundError:
        assert path in NOT_PORTED_PACKAGES, f"the port has no package {path!r}"
        return
    assert path not in NOT_PORTED_PACKAGES, f"{path!r} is ported now: take it off the list"
    names = getattr(jmod, "__all__", None)
    assert names is not None, f"pyfilter_tpu{suffix} has no __all__"
    missing = [n for n in names if not hasattr(tmod, n) and (path, n) not in NOT_PORTED]
    assert not missing, f"pyfilter_tpu_torch{suffix} lacks {missing}"
    stale = [n for n in names if hasattr(tmod, n) and (path, n) in NOT_PORTED]
    assert not stale, f"pyfilter_tpu_torch{suffix} has {stale} now: take them off the list"
    unlisted = [n for n in names if hasattr(tmod, n) and n not in tmod.__all__]
    assert not unlisted, f"pyfilter_tpu_torch{suffix} has {unlisted} but not in its __all__"


def test_the_list_names_only_jax_exports():
    """Every entry of the list is a name the JAX package exports there."""
    for path, name in NOT_PORTED:
        jmod = importlib.import_module("pyfilter_tpu" + ("." + path if path else ""))
        assert name in jmod.__all__, (path, name)


@pytest.mark.parametrize("name,where", [
    ("SMC2", ""), ("NESS", ""), ("NESSMC2", ""), ("SMC2FW", ""), ("PMMH", ""), ("make_context", ""),
    ("Prediction", "filters"), ("Correction", "filters"),
    ("run_pmmh", "inference"), ("AlgorithmState", "inference"), ("FilterAlgorithmState", "inference"),
    ("NotSamePriorError", "inference"), ("ParameterDoesNotExist", "inference"),
    ("find_mode", "filters.particle.proposals"), ("find_optimal_density", "filters.particle.proposals"),
    ("linear_marginal_density", "filters.particle.proposals"),
    ("TemperedSMC", "inference"), ("TemperedSMCResult", "inference"), ("IF2", "inference"),
    ("IF2Result", "inference"), ("crps", "filters"), ("predictive_pit", "filters"),
])
def test_named_exports_are_the_port_objects(name, where):
    """The names this port's exports gained are the port's own objects (the
    aliases are the classes they alias), in ``__all__``."""
    tmod = importlib.import_module("pyfilter_tpu_torch" + ("." + where if where else ""))
    obj = getattr(tmod, name)
    assert name in tmod.__all__
    assert obj.__module__.startswith("pyfilter_tpu_torch")
    if name in ("Prediction", "Correction"):
        assert obj is getattr(tmod, f"ParticleFilter{name}")
