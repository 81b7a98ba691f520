"""A frozen plain copy of the port's AKAZE pipeline, the benchmark's
reference: the FED scale space, detection, orientation and MLDB
descriptor, and brute-force Hamming matching, in plain PyTorch with no
kernel.  The modules are copies of ``akaze_tpu_torch``'s plain paths, so a
later change to the program leaves this reference as it is; nothing here
imports the program or the JAX package.
"""

from .config import AkazeConfig, Diffusivity
from .pipeline import Features, detect_and_compute_batch, match_features
from .plan import build_plan
from .precision import planes_in

__all__ = ["AkazeConfig", "Diffusivity", "Features", "build_plan",
           "detect_and_compute_batch", "match_features", "planes_in"]
