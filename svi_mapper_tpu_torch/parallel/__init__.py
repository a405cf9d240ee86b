from svi_mapper_tpu_torch.parallel import mesh  # noqa: F401
