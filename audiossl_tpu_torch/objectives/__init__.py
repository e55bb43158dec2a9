"""SSL objectives of the port (DeLoRes-S, SS-MAST)."""
from audiossl_tpu_torch.objectives import delores_s, ssmast  # noqa: F401  (register "delores_s", "ssmast")
from audiossl_tpu_torch.objectives.api import get_objective, init_objective

__all__ = ["get_objective", "init_objective"]
