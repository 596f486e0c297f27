from promp_tpu_torch.policies.gaussian_mlp import (  # noqa: F401
    GaussianMLPPolicy, flatten_params, unflatten_params)
