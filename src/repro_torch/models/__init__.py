"""Model definitions: the dense GQA decoder over paged KV pools."""

from repro_torch.models.model import Model  # noqa: F401
