from promp_tpu_torch.optimizers.adam import Adam, AdamState  # noqa: F401
from promp_tpu_torch.optimizers.trpo import (  # noqa: F401
    ConjugateGradientOptimizer, FiniteDifferenceHvp, conjugate_gradients)
