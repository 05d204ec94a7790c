"""The model stack in PyTorch: modules hold the parameters, plain functions
apply them, as the JAX package's init/apply pairs do."""

from repro_torch.models.model import LMModel, forward, init_params

__all__ = ["LMModel", "forward", "init_params"]
