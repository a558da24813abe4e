"""Config registry of the port: the architectures whose path is ported.

Use ``repro_torch.configs.get(name)``.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, GLOBAL, LOCAL, RGLRU, SSD, get, reduced, register,
)
from repro_torch.configs.gemma2_2b import GEMMA2_2B  # noqa: F401
from repro_torch.configs.gemma3_12b import GEMMA3_12B  # noqa: F401
from repro_torch.configs.gemma2_27b import GEMMA2_27B  # noqa: F401
from repro_torch.configs.mistral_large_123b import (  # noqa: F401
    MISTRAL_LARGE_123B,
)
from repro_torch.configs.paligemma_3b import PALIGEMMA_3B  # noqa: F401
from repro_torch.configs.musicgen_large import MUSICGEN_LARGE  # noqa: F401
from repro_torch.configs.olmoe_1b_7b import OLMOE_1B_7B  # noqa: F401
from repro_torch.configs.phi35_moe import PHI35_MOE  # noqa: F401
from repro_torch.configs.mamba2_370m import MAMBA2_370M  # noqa: F401
from repro_torch.configs.recurrentgemma_9b import (  # noqa: F401
    RECURRENTGEMMA_9B,
)
