# `muse` here is the module inference/muse.py; the function is
# cmblensing_tpu_torch.muse (and inference.muse.muse)
from . import muse  # noqa: F401
from .maximization import MAP_joint, MAP_marg, argmaxf_logpdf, sample_f  # noqa: F401
from .muse import MuseProblem, score  # noqa: F401
