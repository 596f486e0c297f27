from promp_tpu_torch.algos.base import MAMLAlgo  # noqa: F401
from promp_tpu_torch.algos.dice_maml import DICEMAML, VPG_DICEMAML, magic_box  # noqa: F401
from promp_tpu_torch.algos.promp import ProMP  # noqa: F401
from promp_tpu_torch.algos.trpo_maml import TRPOMAML  # noqa: F401
from promp_tpu_torch.algos.vpg_maml import VPGMAML  # noqa: F401
