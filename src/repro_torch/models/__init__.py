from repro_torch.models.api import Model, build  # noqa: F401
