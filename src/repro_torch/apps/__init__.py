"""The paper's evaluation applications (CG, Jacobi, N-body, FlexibleSleep);
counterpart of ``repro.apps``."""
from repro_torch.apps.paper_apps import (APPS, CGState, FlexibleSleep,
                                         calibrate, cg_init, cg_step,
                                         data_shardings, jacobi_init,
                                         jacobi_step, laplacian_matvec,
                                         nbody_init, nbody_step)

__all__ = ["APPS", "CGState", "FlexibleSleep", "calibrate", "cg_init",
           "cg_step", "data_shardings", "jacobi_init", "jacobi_step",
           "laplacian_matvec", "nbody_init", "nbody_step"]
