"""The parameter-server runtime: the paper's nine algorithms on the thread
and process transports, and the DES cross-check (the port of
``repro.ps``)."""
from repro_torch.core.async_engine import ALGORITHMS
from repro_torch.ps.problems import (JAX_MLP, NUMPY_MLP, NUMPY_MLP_LARGE,
                                     NUMPY_MLP_MED, ProblemSpec,
                                     make_jax_mlp, make_numpy_mlp, spec)
from repro_torch.ps.runtime import (Calibration, PSConfig, PSResult,
                                    calibrate, calibrate_sim,
                                    measured_link_profile, run_ps,
                                    run_vs_des)
from repro_torch.ps.transport import TRANSPORTS, get_transport

__all__ = ["ALGORITHMS", "Calibration", "JAX_MLP", "NUMPY_MLP",
           "NUMPY_MLP_LARGE", "NUMPY_MLP_MED", "PSConfig", "PSResult",
           "ProblemSpec", "TRANSPORTS", "calibrate", "calibrate_sim",
           "get_transport", "make_jax_mlp", "make_numpy_mlp",
           "measured_link_profile", "run_ps", "run_vs_des", "spec"]
