"""One reference encoder per module, named by the configuration's
``encoder`` in lower case; each has ``forward(x, p, arch, prec, draws)``
and ``LN_EPS``."""
