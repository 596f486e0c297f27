from promp_tpu_torch.optimizers.adam import Adam, AdamState  # noqa: F401
