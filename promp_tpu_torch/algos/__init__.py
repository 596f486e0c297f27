from promp_tpu_torch.algos.base import MAMLAlgo  # noqa: F401
from promp_tpu_torch.algos.promp import ProMP  # noqa: F401
