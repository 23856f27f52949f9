"""kgwas_tpu_torch: the KGWAS framework in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper. Counterpart of the JAX package ``kgwas_tpu``:

    from kgwas_tpu_torch import KGWAS, KGWAS_Data, ukbb_cohort
"""
from .version import __version__
from .config import ModelConfig
from .kgwas import KGWAS
from .kgwas_data import KGWAS_Data
from .cohort.ukbb import ukbb_cohort

__all__ = ["__version__", "ModelConfig", "KGWAS", "KGWAS_Data", "ukbb_cohort"]
