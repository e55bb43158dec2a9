"""Data parallelism across processes: start-up (launch.py) and the step's collectives (dist.py)."""
