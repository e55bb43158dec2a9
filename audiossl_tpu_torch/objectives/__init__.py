"""SSL objectives of the port (DeLoRes-S, DeLoRes-M, SLICER, UnFuSeD, SS-MAST, DECAR-v2)."""
from audiossl_tpu_torch.objectives import decar, delores_m, delores_s, slicer, ssmast, unfused  # noqa: F401  (register them)
from audiossl_tpu_torch.objectives.api import get_objective, init_objective, objective_class

__all__ = ["get_objective", "init_objective", "objective_class"]
