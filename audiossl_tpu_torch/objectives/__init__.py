"""SSL objectives of the port (DeLoRes-S so far)."""
from audiossl_tpu_torch.objectives import delores_s  # noqa: F401  (registers "delores_s")
from audiossl_tpu_torch.objectives.api import get_objective, init_objective

__all__ = ["get_objective", "init_objective"]
